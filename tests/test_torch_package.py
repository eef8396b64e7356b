"""Guards of the port's package boundary and entry point:
- no module of jm_tpu_torch, nor chip_smoke.py, imports jax or jm_tpu;
- a CUDA request without a card raises instead of running on the CPU;
- configurations outside the ported set raise ValueError naming the field
  (md_low, device_rd=False, is inside it, and so is entropy="cabac")."""

import ast
from pathlib import Path

import pytest
import torch

from jm_tpu_torch.encoder.encoder import Encoder, EncoderConfig
from jm_tpu_torch.ops.deblock import deblock


ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "jm_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_no_jax(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "jm_tpu"), \
            f"{path.relative_to(ROOT)} imports {name}"


def test_cuda_request_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Encoder(EncoderConfig(width=32, height=32))
    with pytest.raises(RuntimeError, match="CUDA"):
        Encoder(EncoderConfig(width=32, height=32), device="cuda")


def test_deblock_never_falls_back_for_a_device_request():
    """A non-CPU tensor goes to the kernel wrappers, which refuse it
    here; nothing silently runs the plain CPU version."""
    n = 4
    planes = [torch.zeros(s, dtype=torch.uint8, device="meta")
              for s in ((32, 32), (16, 16), (16, 16))]
    bs = [torch.zeros((8, 8), dtype=torch.int8, device="meta")] * 2
    per_mb = [torch.zeros(n, dtype=torch.int32, device="meta")] * 6
    tabs = [torch.zeros(52, dtype=torch.int32, device="meta")] * 2
    with pytest.raises(ValueError, match="CUDA"):
        deblock(*planes, *bs, *per_mb, *tabs, mb_w=2, mb_h=2)


@pytest.mark.parametrize("field,value", [
    ("intra_mb_refresh", -1), ("search_range", 32), ("search_range", 0),
    ("intra_period", -1), ("qp", 52), ("qp", -1), ("width", 100),
    ("height", 40), ("entropy", "cavcl"), ("cabac_adapt_init", 1),
])
def test_config_outside_slice_raises(field, value):
    cfg = EncoderConfig(width=32, height=32)
    setattr(cfg, field, value)
    with pytest.raises(ValueError, match=field):
        Encoder(cfg, device="cpu")


def test_unknown_device_raises():
    with pytest.raises(ValueError, match="device"):
        Encoder(EncoderConfig(width=32, height=32), device="meta")


@pytest.mark.parametrize("device_rd", [True, False])
def test_p_tiers_accepted(device_rd):
    enc = Encoder(EncoderConfig(width=32, height=32, device_rd=device_rd),
                  device="cpu")
    assert enc.cfg.device_rd is device_rd


def test_device_rd_must_be_a_bool():
    with pytest.raises(ValueError, match="device_rd"):
        Encoder(EncoderConfig(width=32, height=32, device_rd=2), device="cpu")
