import os

# the SIREN --real gates' data: copies of matplotlib's sample files
# (sample_data/README.md)
SAMPLE_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "sample_data")
