"""Package boundary of the PyTorch port: no JAX anywhere in its import graph, and
no kernel build on the CPU path."""
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import representationlearning_tpu_torch as port
from representationlearning_tpu_torch.models.tscd import TSCD
from representationlearning_tpu_torch.ops import _build
from representationlearning_tpu_torch.ops import mit_block as tmb

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."))


def test_every_module_imports_without_jax():
    mods = _modules()
    assert {"representationlearning_tpu_torch." + m for m in (
        "ops.mit_block", "ops.affinity", "ops.varm", "ops.neighbors", "models.refine",
        "wsss.camutils", "train.scd", "ops.attention", "ops.bilateral", "losses.wsss",
        "losses.energy", "train.optim", "train.state", "train.checkpoints", "ops.mlp_dwbn",
        "ops.isa_attention", "models.rssformer_modules", "models.hrnet", "models.rssformer",
        "infer.tta", "infer.sliding", "losses.mi", "models.wavemlp", "models.rml",
        "data.device_transforms", "train.rml", "bench", "losses.cgfl", "losses.discriminative",
        "metrics.seg", "train.rssformer", "models.resnet", "models.irn", "wsss.msf",
        "wsss.indexing", "wsss.wavecam_infer", "ops.crf", "native", "core.config",
        "core.registry", "core.logging", "cli.train_drfl", "models.dcl", "losses.dice",
        "train.drfl", "infer.drfl_eval", "data.medical", "data.transforms", "data.voc",
        "data.coco", "data.prefetch", "convert.coco2voc", "utils.events", "utils.visualize",
        "cli.train_scd", "cli.train_rml", "data.loveda", "cli.rssformer", "models.wavecam",
        "wsss.wavecam_pipeline", "cli.run_wavecam", "models.hrt", "models.asff",
        "cli.convert_checkpoint", "models.baselines", "models.smp_zoo", "utils.affine",
        "utils.profiling", "parallel.mesh", "parallel.collectives", "parallel.launch",
        "parallel.dryrun")} <= set(mods)
    # nor Pillow or OpenCV at load: the card's machine has neither
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', "
            "'flax', 'representationlearning_tpu.', 'PIL.', 'cv2.')) "
            "or k in ('representationlearning_tpu', 'PIL', 'cv2'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, timeout=120)


def test_cpu_forward_never_touches_the_kernel_loader(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("kernel loader called on the CPU path")

    monkeypatch.setattr(_build, "load_library", refuse)
    monkeypatch.setattr(_build, "find_nvcc", refuse)
    m = TSCD("mit_b0", 21, fused_blocks=True, dtype=torch.bfloat16,
             act_dtype=torch.bfloat16, device="cpu").eval()
    with torch.no_grad():
        cls, seg, attns, pred = m(torch.randn(1, 3, 32, 32))
    assert seg.shape == (1, 21, 8, 8) and pred.shape == (1, 4, 4)
    assert torch.isfinite(seg.float()).all()


def test_tscd_builds_on_the_card_unless_asked_for_the_cpu():
    """`device=None` means the card and raises where there is none; the CPU is
    the caller's explicit choice, and the seed alone fixes the weights."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSCD("mit_b0", 21)
    a = TSCD("mit_b0", 21, device="cpu", generator=torch.Generator().manual_seed(3))
    b = TSCD("mit_b0", 21, device=torch.device("cpu"),
             generator=torch.Generator().manual_seed(3))
    assert all(p.device.type == "cpu" for p in a.parameters())
    assert all(torch.equal(u, w) for u, w in zip(a.state_dict().values(),
                                                 b.state_dict().values()))


def test_drfl_entry_points_run_on_the_card_unless_asked_for_the_cpu(tmp_path):
    """DRFL's models, train step, epoch loop and command line take the card by
    default and raise where there is none, before anything is written; the
    seed alone fixes the weights."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from representationlearning_tpu_torch.cli.train_drfl import main
    from representationlearning_tpu_torch.models.dcl import PixelDiscriminator, Softnet
    from representationlearning_tpu_torch.train.drfl import (
        DRFLConfig, make_drfl_train_step, train_drfl)

    for build in (lambda: Softnet(3, 1, 64), lambda: PixelDiscriminator(4, 8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    a, b = (Softnet(3, 1, 64, generator=torch.Generator().manual_seed(2), device=d)
            for d in ("cpu", torch.device("cpu")))
    assert all(p.device.type == "cpu" for p in a.parameters())
    assert all(torch.equal(u, w) for u, w in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_drfl_train_step(a)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_drfl(a, list, list, DRFLConfig(), 1, str(tmp_path / "wd"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["train", "--config", "configs/drfl.yaml", "crop_size=64", "num_vit_layers=1",
              "epochs=1", f"output={tmp_path / 'cli'}"])
    assert not any(tmp_path.iterdir())


def test_wsss_command_lines_run_on_the_card_unless_asked_for_the_cpu(tmp_path):
    """The SCD and RML command lines, and `device_prefetch`, take the card by
    default and raise where there is none, before anything is written."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from representationlearning_tpu_torch.cli import train_rml, train_scd

    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_scd.main(["--config", "configs/scd_voc.yaml", "backbone.config=mit_b0",
                        "dataset.device_augment=true", "train.max_iters=1",
                        f"work_dir.dir={tmp_path / 'scd'}"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_rml.main(["--config", "configs/rml_voc.yaml", "backbone.config=mit_b0",
                        "train.max_iters=1", f"work_dir={tmp_path / 'rml'}"])
    assert not any(tmp_path.iterdir())


def test_rssformer_command_line_runs_on_the_card_unless_asked_for_the_cpu(tmp_path):
    """Each command of the RSSFormer command line takes the card by default and
    raises where there is none, before anything is written."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from representationlearning_tpu_torch.cli import rssformer

    for cmd in (["train"], ["eval", "--tta"], ["predict", "--out_dir", str(tmp_path / "p")]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rssformer.main(cmd + ["--config", "configs/rssformer_loveda.yaml",
                                  "model.hrnet_type=hrnetv2_w18", "train.num_iters=1",
                                  f"work_dir={tmp_path / 'wd'}"])
    assert not any(tmp_path.iterdir())


def test_cpu_refine_never_touches_the_kernel_loader(monkeypatch):
    from representationlearning_tpu_torch.models.refine import par_refine, varm_refine

    def refuse(*a, **k):
        raise AssertionError("kernel loader called on the CPU path")

    monkeypatch.setattr(_build, "load_library", refuse)
    imgs, masks = torch.rand(1, 3, 12, 12) * 255, torch.rand(1, 4, 6, 6)
    for fn in (varm_refine, par_refine):
        out = fn(imgs, masks, dilations=(1, 2), num_iter=2)
        assert out.shape == (1, 4, 12, 12) and torch.isfinite(out).all()


def test_kernel_build_is_keyed_by_the_sources():
    """The build directory is named by a hash of the CUDA sources and flags, and
    it lies under a directory that .gitignore lists."""
    d = _build._digest("mit_block")
    assert len(d) == 16 and d == _build._digest("mit_block")
    assert {p.name for p in (_build.CSRC / "mit_block").glob("*.cu")} == {
        "ln_stats.cu", "gemm.cu", "gemm_f32.cu", "sr_conv.cu", "sr_conv_f32.cu", "attention.cu",
        "attention_f32.cu", "dwconv_gelu.cu"}
    assert {p.name for p in (_build.CSRC / "refine").glob("*.cu")} == {
        "affinity.cu", "varm.cu"}
    assert {p.name for p in (_build.CSRC / "attention").glob("*.cu")} == {
        "flash_fwd.cu", "flash_bwd.cu"}
    assert {p.name for p in (_build.CSRC / "rssformer").glob("*.cu")} == {
        "mlp_dwbn.cu", "mlp_dwbn_fc1_f32.cu", "mlp_dwbn_taps_f32.cu", "isa_attention.cu"}
    # the Hopper building blocks that mit_block and rssformer include are in their keys
    assert _build.SHARED_HEADERS == ("hopper",) and (_build.CSRC / "hopper" / "wgmma.cuh").exists()
    assert len({d, _build._digest("refine"), _build._digest("attention"),
                _build._digest("rssformer")}) == 4
    assert set(_build.SIGNATURES["rssformer"]) == {"k5_mlp_fc1", "k5_fc1_blocks_per_sm",
                                                   "k5_mlp_taps", "k5_taps_blocks_per_sm",
                                                   "k6_isa_core", "k6_isa_blocks_per_sm"}
    assert set(_build.SIGNATURES["refine"]) == {"k2_affinity", "k2_affinity_blocks_per_sm",
                                                "k3_varm_iter", "k3_varm_blocks_per_sm"}
    assert set(_build.SIGNATURES["attention"]) == {"k4_flash_fwd", "k4_flash_fwd_blocks_per_sm",
                                                   "k4_flash_bwd", "k4_flash_bwd_blocks_per_sm"}
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "representationlearning_tpu_torch/_build/" in ignored


def test_fusedblock_refuses_training_mode():
    blk = TSCD("mit_b0", 21, fused_blocks=True, device="cpu").encoder.block1[0]
    blk.train()
    with pytest.raises(ValueError, match="inference-only"):
        blk(torch.zeros(1, 16, 32), 4, 4)


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line without CUDA, in
    the repo and alone in an empty directory."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    src = ROOT / "chip_smoke.py"
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(src.read_text())
    for script, cwd in ((src, ROOT), (alone, tmp_path)):
        r = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                           text=True, timeout=120)
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout


def test_cpu_train_step_never_touches_the_kernel_loader(monkeypatch):
    """The whole train step on CPU tensors: K1, K2, K3 and K4 all take their plain
    versions, forward and backward."""
    from representationlearning_tpu_torch.ops import attention as TA
    from representationlearning_tpu_torch.train import optim as TO
    from representationlearning_tpu_torch.train import scd as TS
    from representationlearning_tpu_torch.train.state import TrainState

    def refuse(*a, **k):
        raise AssertionError("kernel loader called on the CPU path")

    monkeypatch.setattr(_build, "load_library", refuse)
    TA.reset_launches()
    gen = torch.Generator().manual_seed(0)
    m = TSCD("mit_b0", 6, use_flash=True, device="cpu", generator=gen)
    cfg = TS.SCDConfig(num_classes=6, crop_size=128, cam_scales=(1.0,), cam_iters=-1,
                       varm_dilations=(1, 2), varm_iters=2, corr_samples=4)
    state = TrainState.create(m, TO.make_poly_warmup_adamw(m, 6e-5, 0.01, 10, 100))
    batch = {"image": torch.randn(2, 3, 128, 128, generator=gen),
             "cls_label": torch.eye(5)[:2], "img_box": torch.tensor([[0, 128, 0, 128]] * 2)}
    state, metrics = TS.make_scd_train_step(m, cfg, device="cpu")(state, batch, gen)
    assert state.step == 1 and torch.isfinite(metrics["total"])
    assert TA.LAUNCHES == {"flash_fwd": 0, "flash_bwd": 0}
