"""Products and bytes of a pi-GAN training iteration (a D step, then a G
step), worked out from the configuration's shapes.

A dense ``[i, o]`` layer over one point is i * o multiply-adds; a
convolution is c_in * c_out * k * k multiply-adds per output pixel; two FLOPs
each.  A backward counts a layer's weight gradient and its input gradient
(each the forward's products again) where the step asks for them, R1's
double backward included; nothing recomputed is counted.  Each part is
reckoned in the precision the configuration states for it.
"""

from __future__ import annotations

import math


def trunk_macs(cfg: dict) -> tuple:
    """(forward, input-gradient) multiply-adds of the FiLM-SIREN trunk over
    one point (the input layer's gradient excluded: points carry none)."""
    g = cfg["generator"]
    w, hidden = g["hidden_dim"], g["hidden_layers"]
    rgb_in = w + (3 if cfg["use_dir"] else 0)
    fwd = 3 * w + (hidden - 1) * w * w + rgb_in * w + w * 1 + w * 3
    dx = (hidden - 1) * w * w + w * w + w * 1 + w * 3
    return fwd, dx


def mapping_macs(cfg: dict) -> tuple:
    """(forward, input-gradient) multiply-adds of the mapping network for
    one latent."""
    g = cfg["generator"]
    dims = [cfg["z_dim"]] + [g["mapping_hidden_dim"]] * g[
        "mapping_hidden_layers"]
    trunk = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    heads = (g["hidden_layers"] + 1) * dims[-1] * 2 * g["hidden_dim"]
    return trunk + heads, trunk + heads - dims[0] * dims[1]


def disc_convs(cfg: dict, res: int, alpha: float) -> list:
    """(name, c_in, c_out, k, output pixels) of every convolution the
    discriminator runs on one image at ``res``."""
    ch = cfg["discriminator"]["channels"]
    n_layers = len(ch) - 1
    step = n_layers - int(math.log2(res)) + 1
    convs = [(f"adapters.{step}", 3, ch[step], 1, res * res)]
    r = res
    for i in range(step, n_layers):
        convs += [(f"blocks.{i}.res", ch[i], ch[i + 1], 1, r * r),
                  (f"blocks.{i}.conv1", ch[i] + 2, ch[i + 1], 3, r * r),
                  (f"blocks.{i}.conv2", ch[i + 1] + 2, ch[i + 1], 3, r * r)]
        r //= 2
        if i == step and step + 1 < n_layers and 0.0 <= alpha < 1.0:
            convs.append((f"adapters.{step + 1}", 3, ch[step + 1], 1,
                          (res // 2) ** 2))
    convs.append(("out", ch[-1], 1, 2, (r - 1) ** 2))
    return convs


def _conv_macs(convs) -> float:
    return float(sum(ci * co * k * k * px for _, ci, co, k, px in convs))


def points(cfg: dict, stage: dict) -> tuple:
    """(coarse, fine) trunk points of one G forward over the batch."""
    rays = stage["batch"] * stage["resolution"] ** 2
    nc = cfg["render_coarse_sample_num"]
    return rays * nc, rays * (nc + cfg["render_fine_sample_num"])


def trunk_flops(cfg: dict, stage: dict) -> dict:
    """{precision: FLOPs} of the trunk in one iteration: two G forwards (the
    D step's fakes, the G step's) over the coarse and the fine points, and
    the G step's backward over the fine points."""
    fwd, dx = trunk_macs(cfg)
    coarse, fine = points(cfg, stage)
    prec = cfg["precision"]
    out = {prec["trunk_fwd"]: 2.0 * fwd * 2 * (coarse + fine)}
    out[prec["trunk_bwd"]] = out.get(prec["trunk_bwd"], 0.0) + \
        2.0 * (fwd + dx) * fine
    return out


def trunk_bytes(cfg: dict, stage: dict) -> float:
    """Bytes the trunk must move at least in one iteration: each point's
    input (6 floats) and output (4), the fine points' output gradient (4),
    the film codes (read by each of the four passes) and the weights, read
    by each pass, with their gradient written once, in float32."""
    g = cfg["generator"]
    coarse, fine = points(cfg, stage)
    fwd, _ = trunk_macs(cfg)
    film = stage["batch"] * (g["hidden_layers"] + 1) * 2 * g["hidden_dim"]
    return 4.0 * ((6 + 4) * 2 * (coarse + fine) + 4 * fine + 4 * film
                  + 5 * fwd)


def iteration_flops(cfg: dict, stage: dict) -> dict:
    """{precision: FLOPs} of one iteration's model products: the trunk, the
    mapping network, and the discriminator.  D step: forwards on fakes and
    reals (2F), R1's input gradient (F), the loss's weight and input
    gradients on both paths (4F less the image inputs' gradients) and R1's
    double backward (2F less the constant seed of the output layer).  G
    step: a forward on the fakes and the input gradient back to the images
    (2F)."""
    prec = cfg["precision"]
    n, res = stage["batch"], stage["resolution"]
    out = dict(trunk_flops(cfg, stage))

    def add(p, flops):
        out[p] = out.get(p, 0.0) + flops

    m_fwd, m_dx = mapping_macs(cfg)
    add(prec["mapping"], 2.0 * n * (2 * m_fwd + m_fwd + m_dx))
    convs = disc_convs(cfg, res, stage["fade_alpha"])
    f = 2.0 * n * _conv_macs(convs)
    f_img = 2.0 * n * _conv_macs(c for c in convs
                                 if c[0].startswith("adapters."))
    f_out = 2.0 * n * _conv_macs(c for c in convs if c[0] == "out")
    add(prec["disc"], (2 * f + f + 2 * (2 * f - f_img) + (2 * f - f_out))
        + 2 * f)
    return out
