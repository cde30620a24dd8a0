"""The port's checkpoint converter CLI (`cli/convert_checkpoint.py`), as
tests/test_cli.py:179-202 runs the JAX one, with a seeded model on each side:
- every reference family round-trips: a seeded port model's state_dict, saved as
  a DDP `{"state_dict": {"module." + name: ...}}` with the entries the JAX
  converter of the family drops (`num_batches_tracked`, the ImageNet and
  classification heads, HRFormer's dead `norm2`, RSSFormer's `loss.*`), comes
  back equal, loaded strictly into the family's port model;
- every `--from-jax` family: JAX variables drawn over the shapes of the JAX
  model's `init` (numpy, as tests/test_torch_dcl.py does) convert into a
  state_dict that loads strictly into the port's model, value for value where
  a leaf keeps its layout;
- `--no-strict`, `--report`, `--arch`, and an unknown name in strict mode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representationlearning_tpu.models import asff as JA
from representationlearning_tpu.models import dcl as JD
from representationlearning_tpu.models import irn as JI
from representationlearning_tpu.models import resnet as JR
from representationlearning_tpu.models import rml as JRML
from representationlearning_tpu.models import rssformer as JRS
from representationlearning_tpu.models import tscd as JT
from representationlearning_tpu.models import wavecam as JW
from representationlearning_tpu_torch.cli import convert_checkpoint as CC
from representationlearning_tpu_torch.models.asff import HRNetFusion2, RsNetFusion
from representationlearning_tpu_torch.models.dcl import PixelDiscriminator, Softnet
from representationlearning_tpu_torch.models.hrnet import HighResolutionNet
from representationlearning_tpu_torch.models.irn import IRNNet
from representationlearning_tpu_torch.models.mit import MIT_CONFIGS, MixVisionTransformer
from representationlearning_tpu_torch.models.resnet import Net, ResNet50Backbone
from representationlearning_tpu_torch.models.rml import RMLModel
from representationlearning_tpu_torch.models.rssformer import HRNetFusion
from representationlearning_tpu_torch.models.tscd import TSCD, WeTrBaseline
from representationlearning_tpu_torch.models.wavecam import ClassPredictorWavecam

torch.set_num_threads(2)


def _g():
    return torch.Generator().manual_seed(3)


def _cpu(cls, *a, **kw):
    return cls(*a, device="cpu", generator=_g(), **kw)


# family, --arch, the seeded port model, entries the JAX converter drops
REFERENCE_CASES = {
    "mit": ("mit", "mit_b0", lambda: MixVisionTransformer(**MIT_CONFIGS["mit_b0"]),
            {"head.weight": torch.ones(3, 256), "head.bias": torch.ones(3)}),
    "tscd": ("tscd", "mit_b0", lambda: _cpu(TSCD, "mit_b0", 5), {}),
    "resnet50": ("resnet50", None, ResNet50Backbone,
                 {"fc.weight": torch.ones(3, 2048), "fc.bias": torch.ones(3)}),
    "wavecam_net": ("wavecam_net", None, lambda: _cpu(Net, n_classes=7),
                    {"bg.weight": torch.ones(1), "stage1.0.weight": torch.ones(2),
                     "newly_added.0.weight": torch.ones(2)}),
    "hrnet_plain": ("hrnet", "hrnetv2_w18",
                    lambda: HighResolutionNet("hrnetv2_w18", with_transformer=False),
                    {"final_layer.0.weight": torch.ones(2),
                     "incre_modules.0.0.bias": torch.ones(2)}),
    "hrnet_rssformer": ("hrnet", "hrnetv2_w18", lambda: HighResolutionNet("hrnetv2_w18"), {}),
    "rssformer": ("rssformer", "hrnetv2_w18", lambda: _cpu(HRNetFusion, "hrnetv2_w18", 5),
                  {"loss.weight": torch.ones(5)}),
    "rssformer_hrt": ("rssformer", "hrt_small", lambda: _cpu(HRNetFusion, "hrt_small", 7),
                      {"backbone.hrnet.stage3.2.branches.1.0.norm2.weight": torch.ones(64),
                       "backbone.hrnet.stage3.2.branches.1.0.norm2.bias": torch.ones(64),
                       "backbone.hrnet.classifier.weight": torch.ones(2)}),
}


def _save_reference(path, model, extra, rename=lambda k: k):
    sd = {"module." + rename(k): v for k, v in {**model.state_dict(), **extra}.items()}
    torch.save({"state_dict": sd}, path)
    return model.state_dict()


def _argv(family, src, dst, arch=None, *more):
    return ["--family", family, "--src", str(src), "--dst", str(dst),
            *(["--arch", arch] if arch else []), *more]


def _equal(got, want):
    assert sorted(got) == sorted(want)
    for k, t in want.items():
        assert got[k].dtype == t.dtype and got[k].shape == t.shape, k
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == 0, k      # dropped, as the JAX converters drop it
        else:
            assert torch.equal(got[k], t), k


@pytest.mark.parametrize("case", sorted(REFERENCE_CASES))
def test_reference_families_round_trip(case, tmp_path, capsys):
    family, arch, build, extra = REFERENCE_CASES[case]
    model = build()
    with torch.no_grad():      # counters the converter drops and resets
        for k, t in model.state_dict().items():
            if k.endswith("num_batches_tracked"):
                t.fill_(7)
    want = _save_reference(tmp_path / "ref.pth", model, extra)
    out = CC.main(_argv(family, tmp_path / "ref.pth", tmp_path / "out.pt", arch, "--report"))
    _equal(out, want)
    _equal(torch.load(tmp_path / "out.pt", weights_only=True), want)
    text = capsys.readouterr().out
    n = len(want) + len(extra)
    assert f"reference entries read: {n}" in text and f"wrote {tmp_path / 'out.pt'}" in text
    assert "not loaded" not in text


@pytest.mark.parametrize("prefix", ["backbone.model.", "backbone.encoder.", "backbone."])
def test_rssformer_encoder_wrappers(prefix, tmp_path):
    """The encoder's wrapper prefixes `convert_rssformer` accepts land under the
    port's `backbone.hrnet.`."""
    model = _cpu(HRNetFusion, "hrnetv2_w18", 5)
    want = _save_reference(tmp_path / "ref.pth", model, {},
                           lambda k: k.replace("backbone.hrnet.", prefix, 1))
    _equal(CC.main(_argv("rssformer", tmp_path / "ref.pth", tmp_path / "o.pt", "hrnetv2_w18")),
           want)


def test_strictness_report_and_arch(tmp_path, capsys):
    model = _cpu(HRNetFusion, "hrnetv2_w18", 5)
    want = _save_reference(tmp_path / "ref.pth", model, {"neck.extra.weight": torch.ones(2)})
    argv = _argv("rssformer", tmp_path / "ref.pth", tmp_path / "o.pt", "hrnetv2_w18")
    with pytest.raises(RuntimeError, match="neck.extra.weight"):
        CC.main(argv)     # an unknown name fails in strict mode
    capsys.readouterr()
    _equal(CC.main(argv + ["--no-strict", "--report"]), want)
    assert "not loaded: ['neck.extra.weight']" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="size mismatch"):   # the width is --arch's
        CC.main(_argv("rssformer", tmp_path / "ref.pth", tmp_path / "o.pt", "hrnetv2_w32"))
    with pytest.raises(ValueError, match="is not one of rssformer's"):
        CC.main(_argv("rssformer", tmp_path / "ref.pth", tmp_path / "o.pt", "mit_b1"))
    with pytest.raises(SystemExit):
        CC.main(_argv("irn", tmp_path / "ref.pth", tmp_path / "o.pt"))   # --from-jax only


def draw_variables(module, *args, seed=0):
    """Numpy draws over the shapes of ``module.init(key, *args)``."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


def _x(side=64):
    return jnp.zeros((1, side, side, 3))


def _wavecam_pred():
    return draw_variables(JW.ClassPredictorWavecam(20, 2048), jnp.zeros((1, 20, 2048)),
                          jnp.ones((1, 20)), jnp.zeros((1, 32, 32, 20)))


# --from-jax family: (JAX variables, the port model they load into)
FROM_JAX_CASES = {
    "tscd": lambda: (draw_variables(JT.TSCD("mit_b0", 5), _x()), _cpu(TSCD, "mit_b0", 5)),
    "wetr_baseline": lambda: (draw_variables(JT.WeTrBaseline("mit_b0", 5), _x()),
                              _cpu(WeTrBaseline, "mit_b0", 5)),
    "rml": lambda: (draw_variables(JRML.RMLModel("mit_b0", 21, use_wave=True), _x()),
                    _cpu(RMLModel, "mit_b0", 21, use_wave=True)),
    "rssformer": lambda: (draw_variables(JRS.HRNetFusion("hrt_small", 7), _x()),
                          _cpu(HRNetFusion, "hrt_small", 7)),
    "rsnet_fusion": lambda: (draw_variables(JA.RsNetFusion("hrnetv2_w18", 7), _x()),
                             _cpu(RsNetFusion, "hrnetv2_w18", 7)),
    "hrnet_fusion2": lambda: (draw_variables(JA.HRNetFusion2("hrnetv2_w18", 7), _x()),
                              _cpu(HRNetFusion2, "hrnetv2_w18", 7)),
    "wavecam_net": lambda: (draw_variables(JR.Net(16, 20), _x()), _cpu(Net, n_classes=20)),
    "wavecam_predictor": lambda: (_wavecam_pred(),
                                  ClassPredictorWavecam(20, 2048, device="cpu")),
    "resnet50": lambda: (draw_variables(JR.ResNet50Backbone(), _x()), ResNet50Backbone()),
    "irn": lambda: (draw_variables(JI.IRNNet(), _x()), IRNNet(device="cpu")),
    "dcl": lambda: (draw_variables(JD.Softnet(3, 1), _x()), Softnet(3, 1, 64, device="cpu")),
    "pixel_discriminator": lambda: (draw_variables(JD.PixelDiscriminator(16),
                                                   jnp.zeros((1, 5, 5, 4))),
                                    PixelDiscriminator(4, 16, device="cpu")),
}


@pytest.mark.parametrize("family", sorted(FROM_JAX_CASES))
def test_from_jax_families_load_strictly(family, tmp_path):
    variables, model = FROM_JAX_CASES[family]()
    np.save(tmp_path / "v.npy", variables, allow_pickle=True)
    out = CC.main(["--from-jax", *_argv(family, tmp_path / "v.npy", tmp_path / "o.pt")])
    model.load_state_dict(out, strict=True)
    assert sorted(torch.load(tmp_path / "o.pt", weights_only=True)) == sorted(out)
    flat = {"/".join(k.key for k in path): np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(variables)[0]}
    same = {k: t for k, t in model.state_dict().items()
            if t.ndim == 1 and not k.endswith("num_batches_tracked")}
    # every 1-d leaf keeps its layout: each such entry is one of JAX's leaves
    assert same and all(any(a.shape == t.shape and np.array_equal(a, t.numpy())
                            for a in flat.values()) for t in same.values())


def test_train_wavecam_file(tmp_path):
    """`train_wavecam`'s {"net", "pred"} file -> the two state_dicts."""
    v = {"net": draw_variables(JR.Net(16, 20), _x()), "pred": _wavecam_pred()}
    np.save(tmp_path / "w.npy", v, allow_pickle=True)
    out = CC.main(["--from-jax", "--family", "train_wavecam", "--src", str(tmp_path / "w.npy"),
                   "--dst", str(tmp_path / "w.pt"), "--report"])
    assert set(out) == {"net", "pred"}
    _cpu(Net, n_classes=20).load_state_dict(out["net"], strict=True)
    ClassPredictorWavecam(20, 2048, device="cpu").load_state_dict(out["pred"], strict=True)
