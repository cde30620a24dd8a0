"""The port's config tree, registry and logging (`core/`) against the JAX
package's: the same operations give the same trees, values, errors and
messages. `load_yaml` of `configs/drfl.yaml`; the DRFL components registered
under the JAX package's names."""
import copy
import logging
import sys
from pathlib import Path

import pytest

from representationlearning_tpu.core import config as JC
from representationlearning_tpu.core import logging as JG
from representationlearning_tpu.core import registry as JR
from representationlearning_tpu_torch.core import config as TC
from representationlearning_tpu_torch.core import logging as TG
from representationlearning_tpu_torch.core import registry as TR

ROOT = Path(__file__).resolve().parent.parent
BASE = {"train": {"max_iters": 10, "lr": 0.1, "scales": [1, 0.5]}, "name": "x",
        "items": [{"a": 1}, 2]}
OVERRIDES = ["train.max_iters=100", "train.scales=[1,0.5,2]", "model.dropout=0.1",
             "name=plain-text", "flag=True", "none=None", "train.eval_interval_epoch", "20",
             "nested.deeper.leaf={'k': (1, 2)}"]


def _ops(mod):
    cfg = mod.Config(BASE, extra=3)
    out = {"attr": cfg.train.max_iters, "items_type": type(cfg["items"][0]).__name__}
    cfg.merge({"train": {"lr": 0.2, "new": {"x": 1}}, "name": "y"})
    cfg.apply_overrides(OVERRIDES)
    out["tree"] = cfg.to_dict()
    out["dotted"] = (cfg.get_dotted("train.new.x"), cfg.get_dotted("no.such", "dflt"))
    c2 = copy.deepcopy(cfg)
    c2.train.lr = 5
    out["copy_independent"] = cfg.train.lr == 0.2 and type(c2).__name__ == "Config"
    with pytest.raises(AttributeError):
        cfg.missing_key
    with pytest.raises(ValueError, match="has no value") as e:
        mod.Config().apply_overrides(["dangling"])
    out["error"] = str(e.value)
    return out


def test_config_ops_match_jax():
    assert _ops(TC) == _ops(JC)


def test_load_yaml_matches_jax():
    path = str(ROOT / "configs" / "drfl.yaml")
    got, want = TC.load_yaml(path), JC.load_yaml(path)
    assert isinstance(got, TC.Config) and got.to_dict() == want.to_dict()
    assert got.crop_size == 256 and got.data_path is None and got.threshold == 150


def test_import_config_matches_jax(tmp_path, monkeypatch):
    (tmp_path / "drfl_cfg_mod.py").write_text("config = {'a': {'b': 2}, 'c': [1, 2]}\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    got, want = TC.import_config("drfl_cfg_mod"), JC.import_config("drfl_cfg_mod")
    assert isinstance(got, TC.Config) and got.to_dict() == want.to_dict() and got.a.b == 2


def _registry_behaviour(mod):
    reg = mod.Registry("things")
    out = {}

    @reg.register()
    class Alpha:
        def __init__(self, v=1):
            self.v = v

    reg.register("beta")(dict)
    out["keys"] = sorted(reg.keys())
    out["contains"] = ("Alpha" in reg, "gamma" in reg)
    out["build"] = reg.build("Alpha", v=7).v
    for fn in (lambda: reg.register("beta")(list), lambda: reg.get("gamma")):
        with pytest.raises(KeyError) as e:
            fn()
        out.setdefault("errors", []).append(str(e.value))
    return out


def test_registry_matches_jax():
    assert _registry_behaviour(TR) == _registry_behaviour(JR)


def test_drfl_components_registered_under_jax_names():
    from representationlearning_tpu_torch.data.medical import DRFLPairedDataset
    from representationlearning_tpu_torch.models.dcl import PixelDiscriminator, Softnet

    assert TR.MODELS.get("Softnet") is Softnet
    assert TR.MODELS.get("PixelDiscriminator") is PixelDiscriminator
    assert TR.DATASETS.get("drfl_paired") is DRFLPairedDataset
    assert {r.name for r in (TR.MODELS, TR.DATASETS, TR.LOSSES)} == {
        r.name for r in (JR.MODELS, JR.DATASETS, JR.LOSSES)}


ZOO = {"UNetPP", "LinkNet", "DeepLabV3", "DeepLabV3Plus", "MANet", "PAN", "trans",
       "FarSegV1", "SemanticFPN", "PSPNet", "FCN8s", "AnyUNet", "FactSeg", "SemanticFPNDecouple"}


def test_models_registered_under_jax_names():
    """Every model of the JAX registry, the baseline zoo's fourteen included,
    under its JAX name."""
    import importlib

    for pkg in ("representationlearning_tpu", "representationlearning_tpu_torch"):
        for m in ("dcl", "rssformer", "rml", "wavecam", "irn", "tscd", "asff", "resnet",
                  "smp_zoo", "baselines"):
            importlib.import_module(f"{pkg}.models.{m}")
    assert len(JR.MODELS.keys()) == 27 and ZOO <= set(JR.MODELS.keys())
    assert set(TR.MODELS.keys()) == set(JR.MODELS.keys())
    from representationlearning_tpu_torch.models.asff import HRNetFusion2, RsNetFusion
    from representationlearning_tpu_torch.models.rssformer import HRNetFusion
    from representationlearning_tpu_torch.models.tscd import TSCD, WeTrBaseline

    assert [TR.MODELS.get(n) for n in ("TSCD", "WeTrBaseline", "RSSFormer", "rsNetFusion",
                                       "HRNetFusion2")] == [TSCD, WeTrBaseline, HRNetFusion,
                                                            RsNetFusion, HRNetFusion2]
    # each zoo model in the module of the same name as its JAX counterpart's
    assert {n: TR.MODELS.get(n).__module__.rsplit(".", 1)[1] for n in ZOO} == {
        n: JR.MODELS.get(n).__module__.rsplit(".", 1)[1] for n in ZOO}


def test_logger_matches_jax(tmp_path):
    records = {}
    for tag, mod in (("port", TG), ("jax", JG)):
        path = tmp_path / f"{tag}.log"
        log = mod.setup_logger(f"drfl_test_{tag}", str(path))
        log.info("epoch %d dice=%.4f", 3, 0.5)
        quiet = mod.setup_logger(f"drfl_test_{tag}_quiet", str(tmp_path / "q.log"), is_main=False)
        records[tag] = (log.level, [type(h).__name__ for h in log.handlers],
                        [h.stream is sys.stdout for h in log.handlers
                         if type(h) is logging.StreamHandler],
                        path.read_text().split(" INFO ")[1], quiet.level, len(quiet.handlers))
        for h in log.handlers:
            h.close()
    assert records["port"] == records["jax"]
    assert records["port"][3] == "epoch 3 dice=0.5000\n"


def _meter_and_timer(mod):
    m = mod.AverageMeter("loss")
    m.add(loss=1.0, acc=0.5)
    m.add(loss=3.0)
    out = [m.get("loss"), m.get("acc"), m.get("none"), m.pop("loss"), m.get("loss"), m.pop()]
    t = mod.Timer(total_steps=10)
    out += [t.eta(0) != t.eta(0), t.tick() >= 0.0, t.elapsed() >= 0.0, t.throughput(5) >= 0.0]
    return out


def test_meter_and_timer_match_jax():
    assert _meter_and_timer(TG) == _meter_and_timer(JG)
