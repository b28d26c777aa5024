"""The port's device defaults: the pi-GAN trunk mode when
MSRA_TPU_FUSED_FILM is unset (as the JAX package picks it off the TPU), and
the plain-precision settings both trainers apply."""

import pytest
import torch

from msra_practice_project_tpu_torch import set_plain_precision
from msra_practice_project_tpu_torch.models import pigan


@pytest.fixture(scope="module")
def trunk():
    return pigan.Generator(pigan.GeneratorConfig(z_dim=16),
                           generator=torch.Generator().manual_seed(0)).trunk


def test_trunk_mode_defaults_to_plain_off_cuda(trunk, monkeypatch):
    """Unset: mode 0 (plain autograd) for CPU tensors, as the JAX package
    takes mode 0 off the TPU, and the hybrid mode 1 for CUDA tensors; a
    value that is set wins on either device."""
    monkeypatch.delenv("MSRA_TPU_FUSED_FILM", raising=False)
    assert trunk._fused_mode(torch.device("cpu")) == 0
    assert trunk._fused_mode(torch.device("cuda")) == 1
    for mode in (0, 1, 2):
        monkeypatch.setenv("MSRA_TPU_FUSED_FILM", str(mode))
        assert trunk._fused_mode(torch.device("cpu")) == mode
        assert trunk._fused_mode(torch.device("cuda")) == mode


@pytest.mark.parametrize("raw", ["hybrid", "7"])
def test_trunk_mode_warns_and_takes_hybrid_on_bad_values(trunk, monkeypatch,
                                                         raw):
    """A value that is not 0, 1 or 2 warns and takes mode 1 on either
    device, as the JAX package's reader does."""
    monkeypatch.setenv("MSRA_TPU_FUSED_FILM", raw)
    for dev in ("cpu", "cuda"):
        with pytest.warns(UserWarning):
            assert trunk._fused_mode(torch.device(dev)) == 1


def test_set_plain_precision_makes_cudnn_deterministic():
    """No TF32 and deterministic cuDNN (no autotuned algorithm choice), so
    pi-GAN's convolutions repeat bitwise on the card."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    try:
        torch.backends.cudnn.deterministic = False
        torch.backends.cudnn.benchmark = True
        set_plain_precision()
        assert torch.backends.cudnn.deterministic is True
        assert torch.backends.cudnn.benchmark is False
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is False
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
