"""FLOP and byte counts worked out from each configuration's shapes, and the
card's published peaks."""
