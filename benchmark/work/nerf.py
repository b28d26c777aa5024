"""Products and bytes of NeRF's train step and view render, worked out from
the configuration's shapes (not from the program's tables).

A product of an ``[i, o]`` dense layer over one point is i * o multiply-adds,
two FLOPs each.  The train step counts each MLP's forward, its weight
gradients (the forward's products again) and its input gradients through
every layer whose input holds an activation; the positional encodings need
none, since the points carry no gradient.  Nothing that one implementation
recomputes or spills is counted.
"""

from __future__ import annotations

from ..reference.nerf import layer_dims


def _pe_widths(net: dict) -> tuple:
    return 3 * 2 * net["pe_pos_length"], 3 * 2 * net["pe_dir_length"]


def forward_macs(net: dict) -> int:
    """Multiply-adds of one MLP forward over one point."""
    return sum(i * o for _, i, o, _ in layer_dims(net))


def input_grad_macs(net: dict) -> int:
    """Multiply-adds of the input gradients of one point: each layer's
    activation inputs (a layer's positional-encoding columns excluded)."""
    pe_pos, pe_dir = _pe_widths(net)
    pe_cols = {"layers_pos.0": pe_pos,
               f"layers_pos.{net['skip_after'] + 1}": pe_pos,
               "layers_dir.1": pe_dir}
    return sum((i - pe_cols.get(name, 0)) * o
               for name, i, o, _ in layer_dims(net))


def points_per_ray(cfg: dict) -> tuple:
    """(coarse, fine) MLP points a ray takes."""
    nc = cfg["render_coarse_sample_num"]
    return nc, nc + cfg["render_fine_sample_num"]


def train_step_flops(cfg: dict, rays: int) -> dict:
    """{precision: FLOPs} of one train step over ``rays`` rays: both MLPs'
    forward, weight and input gradients, in the train MLP's precision."""
    net = cfg["net"]
    per_point = 2 * (2 * forward_macs(net) + input_grad_macs(net))
    return {cfg["precision"]["mlp_train"]: per_point * rays * sum(
        points_per_ray(cfg))}


def train_step_mlp_bytes(cfg: dict, rays: int) -> float:
    """Bytes the two MLPs of one train step must move at least: each point's
    input (6 floats), output and output gradient (4 floats each), and every
    weight read once and its gradient written once, in float32."""
    net = cfg["net"]
    points = rays * sum(points_per_ray(cfg))
    weights = sum(i * o + o for _, i, o, _ in layer_dims(net))
    models = 2 if cfg["use_fine_model"] else 1
    return 4.0 * (points * (6 + 4 + 4) + models * 2 * weights)


def view_flops(cfg: dict, rays: int) -> dict:
    """{precision: FLOPs} of rendering ``rays`` rays with the render MLPs."""
    return {cfg["precision"]["mlp_render"]: 2 * forward_macs(cfg["net"])
            * rays * sum(points_per_ray(cfg))}
