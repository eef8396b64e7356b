"""Guards of the port's package boundary and entry point:
- no module of jm_tpu_torch, nor chip_smoke.py, imports jax or jm_tpu;
- the port's C++ runtime is its own: built from jm_tpu_torch/native only,
  under its own module name;
- a CUDA request without a card raises instead of running on the CPU;
- configurations outside the ported set raise ValueError naming the field
  (md_low, device_rd=False, is inside it, and so is entropy="cabac")."""

import ast
import subprocess
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


def test_scan_covers_the_native_loader():
    assert ROOT / "jm_tpu_torch" / "native" / "__init__.py" in PORT_FILES


@pytest.mark.parametrize("rel", ["ratectl.py", "common/fmo.py",
                                 "encoder/intra_host.py",
                                 "encoder/sei_write.py", "decoder/sei.py",
                                 "decoder/b_slice.py", "encoder/b_host.py",
                                 "encoder/gop.py", "encoder/me.py",
                                 "decoder/wp.py", "encoder/wp_est.py",
                                 "encoder/p_host.py", "encoder/qmatrix.py",
                                 "encoder/me_epzs.py", "encoder/me_umhex.py",
                                 "encoder/rdo.py", "encoder/rdoq.py",
                                 "encoder/errdo.py", "config.py",
                                 "common/config_map.py", "metrics.py",
                                 "tools/input.py", "tools/lencod.py",
                                 "tools/ldecod.py", "bitstream/rtp.py",
                                 "encoder/leaky_bucket.py",
                                 "encoder/checkpoint.py",
                                 "parallel/mesh.py",
                                 "parallel/sp_pipeline.py",
                                 "parallel/gop_pipeline.py",
                                 "tools/trace.py", "tools/bdrate.py",
                                 "tools/imgio.py", "tools/rtpdump.py",
                                 "tools/rtp_loss.py"])
def test_scan_covers_the_ports_own_copies(rel):
    """Rate control, the slice-group maps, the host intra encoder, the
    SEI writers and parser, the B-slice motion, the B and P MB coders
    with their motion search and fast searchers, the GOP strings and the
    explicit sequence coder, the weighted prediction tables and
    estimates, the custom quant, the RD tools with the basic units' bit
    count, the trellis and the simulated lossy decoders, the config
    layer with its parameter schema, the metrics, the source readers,
    the lencod / ldecod entry points, the RTP container, the leaky
    bucket, the checkpoint, the parallel axes (the device meshes, the
    MB-row sharded P step, the GOP pipeline) and the host tools (the
    syntax-element trace, the BD-rate harness, the image I/O, rtpdump and
    rtp_loss) are the port's own modules, not jm_tpu's."""
    assert ROOT / "jm_tpu_torch" / rel in PORT_FILES


def test_native_build_uses_only_the_ports_sources(monkeypatch, tmp_path):
    """The loader's compile command names the three sources beside it and
    nothing of native/ or jm_tpu/native/."""
    from jm_tpu_torch import native as N
    cmds = []

    def run(cmd, **kw):
        cmds.append(cmd)
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(N.subprocess, "run", run)
    out = N.build(build_dir=tmp_path)
    assert out.parent == tmp_path and out.name.startswith("jm_torch_native")
    (cmd,) = cmds
    srcs = [Path(a) for a in cmd if a.endswith((".cpp", ".cc", ".c"))]
    assert sorted(p.name for p in srcs) == sorted(N.SOURCES)
    for p in srcs:
        assert p.parent == ROOT / "jm_tpu_torch" / "native"
    for a in cmd:
        for other in (ROOT / "native", ROOT / "jm_tpu" / "native"):
            assert not Path(a).is_relative_to(other), a
    # up to date now: a second call compiles nothing
    N.build(build_dir=tmp_path)
    assert len(cmds) == 1


def test_native_module_has_its_own_name():
    """Both packages' runtimes load in one process: the port's module and
    its types are named jm_torch_native, not jm_native."""
    from jm_tpu_torch import native as N
    src = (ROOT / "jm_tpu_torch" / "native" / "jm_native.cpp").read_text()
    assert "PyInit_jm_torch_native" in src and "PyInit_jm_native(" not in src
    mod = N.load()
    assert mod.__name__ == N.MODULE == "jm_torch_native"
    assert type(mod.BitReader(b"\x80")).__module__ == "jm_torch_native"
    assert mod.CabacEngine.__module__ == "jm_torch_native"


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
    ("intra_mb_refresh", -1), ("search_range", -1), ("search_range", 0),
    ("intra_period", -1), ("qp", 52), ("qp", -1), ("width", 100),
    ("height", 40), ("entropy", "cavcl"), ("cabac_adapt_init", 1),
    ("search_range", -17), ("qp_p", 52), ("poc_type", 3), ("slice_mode", 3),
    ("slice_argument", -1), ("num_slice_groups", 9), ("rc_enable", 1),
    ("rc_basic_unit", -1), ("rc_initial_qp", 52), ("deblock", 0),
    ("enable_vui", 1), ("sei_user_data", "text"), ("long_term_period", -1),
    ("ref_reorder", 2), ("poc_mem_mgmt", 2), ("data_partition", 2),
    ("redundant_period", -1), ("redundant_qp_off", 52),
    ("redundant_qp_off", -1), ("num_b", -1), ("num_b", 1.5),
    ("hierarchical", 2), ("explicit_gop", 3), ("qp_b", 52), ("qp_b", -1),
    ("sei_recovery_point", 1), ("mmco_policy", "idr"),
    ("weighted_pred", 2), ("weighted_pred", True), ("wp_method", 2),
    ("wp_iter_mc", -1), ("wp_iter_mc", 1.5), ("wp_mcprec", 2),
    ("weighted_bipred", 3), ("pipeline", "gpu"), ("transform8x8", 1),
    ("adaptive_rounding", 1), ("scaling_matrix", 4), ("scaling_matrix", True),
    ("scaling_lists4", ((16,) * 16,)), ("scaling_lists8", ((0,) * 64,) * 2),
    ("scaling_present", (4,)), ("offset_matrix", ((0,),)),
    ("adapt_rnd_period", -1), ("adapt_rnd_w", 1.5),
    ("search_mode", 4), ("num_ref", 0), ("num_ref", 17),
])
def test_config_outside_slice_raises(field, value):
    cfg = EncoderConfig(width=32, height=32)
    setattr(cfg, field, value)
    with pytest.raises(ValueError, match=field):
        Encoder(cfg, device="cpu")


def test_rate_control_needs_a_bit_rate():
    with pytest.raises(ValueError, match="rc_bitrate"):
        Encoder(EncoderConfig(width=32, height=32, rc_enable=True),
                device="cpu")


@pytest.mark.parametrize("kw,field", [
    (dict(entropy="cabac"), "num_slice_groups"),
    (dict(weighted_pred=1), "num_slice_groups"),
    (dict(weighted_bipred=2), "num_slice_groups"),
    (dict(slice_group_map_type=7), "slice_group_map_type"),
    (dict(slice_group_map_type=2, sg_top_left=(0,)), "sg_top_left"),
    (dict(slice_group_map_type=6, sg_ids=(0, 1)), "sg_ids"),
])
def test_fmo_config_outside_slice_raises(kw, field):
    """FMO is Baseline only (jm_tpu raises for profile 77, which CABAC or
    weighted prediction make, too), and the map's parameters must fit
    the picture."""
    with pytest.raises(ValueError, match=field):
        Encoder(EncoderConfig(width=32, height=32, num_slice_groups=2, **kw),
                device="cpu")


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
