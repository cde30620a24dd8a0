"""`ops/_build.py::_compile` with `nvcc` stubbed out: one compile per source,
all started before any is waited for, then one link; a failure of either step
raises with the command that failed. `build_all` compiles every library once and
loads none."""
import subprocess
from pathlib import Path

import pytest

from representationlearning_tpu_torch.ops import _build


class _FakeNvcc:
    """Stands in for `subprocess.Popen` (the compiles) and `subprocess.run`
    (the link). Records every command and the order of starts and waits."""

    def __init__(self, fail_compile: str | None = None, fail_link: bool = False):
        self.fail_compile, self.fail_link = fail_compile, fail_link
        self.compiles: list[list[str]] = []
        self.links: list[list[str]] = []
        self.events: list[str] = []

    def popen(self, cmd, **kw):
        assert kw["stderr"] == subprocess.STDOUT and kw["text"]
        fake = self
        fake.compiles.append(cmd)
        fake.events.append("start")

        class Proc:
            returncode = 1 if fake.fail_compile and cmd[-1].endswith(fake.fail_compile) else 0

            def communicate(self):
                fake.events.append("wait")
                return f"ptxas info: {Path(cmd[-1]).name}\n", None

        return Proc()

    def run(self, cmd, **kw):
        self.links.append(cmd)
        self.events.append("link")
        rc = 1 if self.fail_link else 0
        if rc == 0:
            Path(cmd[cmd.index("-o") + 1]).write_bytes(b"so")
        return subprocess.CompletedProcess(cmd, rc, stdout="", stderr="undefined symbol")


@pytest.fixture
def fake(monkeypatch):
    def install(**kw):
        f = _FakeNvcc(**kw)
        monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
        monkeypatch.setattr(_build.subprocess, "Popen", f.popen)
        monkeypatch.setattr(_build.subprocess, "run", f.run)
        return f
    return install


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_compile_runs_one_nvcc_per_source_then_links(fake, tmp_path, name):
    f = fake()
    out = tmp_path / "abc" / f"lib{name}.so"
    ptxas = _build._compile(name, out)
    sources = sorted((_build.CSRC / name).glob("*.cu"))
    assert len(sources) >= 2
    assert [c[-1] for c in f.compiles] == [str(s) for s in sources]
    objects = []
    for cmd, src in zip(f.compiles, sources):
        assert cmd[0] == "nvcc" and tuple(cmd[1:1 + len(_build.NVCC_FLAGS)]) == _build.NVCC_FLAGS
        assert "arch=compute_90a,code=sm_90a" in cmd and "--use_fast_math" not in cmd
        assert cmd[-4:-2] == ["-c", "-o"] and Path(cmd[-2]).name == src.stem + ".o"
        objects.append(cmd[-2])
    # every compile is started before the first is waited for; the link comes last
    n = len(sources)
    assert f.events == ["start"] * n + ["wait"] * n + ["link"]
    (link,) = f.links
    assert link[:3] == ["nvcc", "-shared", "-o"] and link[4:] == objects
    assert out.read_bytes() == b"so"
    assert list(out.parent.iterdir()) == [out]  # objects and the temporary directory are gone
    assert all(s.name in ptxas for s in sources)


def test_compile_failure_names_the_command(fake, tmp_path):
    f = fake(fail_compile="varm.cu")
    out = tmp_path / "lib" / "librefine.so"
    with pytest.raises(RuntimeError, match=r"nvcc failed \(1\)(.|\n)*varm\.cu"):
        _build._compile("refine", out)
    assert not f.links and not out.exists()


def test_link_failure_raises_and_leaves_no_library(fake, tmp_path):
    fake(fail_link=True)
    out = tmp_path / "lib" / "librefine.so"
    with pytest.raises(RuntimeError, match=r"nvcc failed \(1\)(.|\n)*-shared(.|\n)*undefined"):
        _build._compile("refine", out)
    assert not out.exists()


def test_signatures_name_sources_that_exist():
    for name, fns in _build.SIGNATURES.items():
        text = "".join(p.read_text() for p in _build._sources(name))
        for fn in fns:
            assert f"int {fn}(" in text, f"{fn} is not defined under csrc/{name}/"
    assert set(_build._locks) == set(_build.SIGNATURES)


def test_build_all_compiles_every_library_once_and_loads_none(fake, tmp_path, monkeypatch):
    """What the bench's parent calls before it starts its children: every library
    lands where `load_library` looks for it, no library is loaded (no CUDA
    context), and a second call finds them all built."""
    def refuse(*a, **k):
        raise AssertionError("a library was loaded")

    f = fake()
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.ctypes, "CDLL", refuse)
    paths = _build.build_all()
    assert set(paths) == set(_build.SIGNATURES)
    for name, path in paths.items():
        assert path == tmp_path / _build._digest(name) / f"lib{name}.so"
        assert path.read_bytes() == b"so"
        ptxas = path.with_suffix(".ptxas.txt").read_text()
        assert all(src.name in ptxas for src in _build._sources(name))
    assert len(f.links) == len(_build.SIGNATURES)
    assert len(f.compiles) == sum(len(_build._sources(n)) for n in _build.SIGNATURES)
    assert _build.build_all() == paths and len(f.links) == len(_build.SIGNATURES)
