"""No module of the harness loads JAX or the JAX package, and the plain
reference loads nothing of the measured program.  Top-level module names
(the part before the first dot) are compared whole: the program's name
begins with the JAX package's."""

import json
import subprocess
import sys
from pathlib import Path

from portbench.core.cells import REPO, ROOT
from portbench.core.result import FORBIDDEN, forbidden_modules

HARNESS = sorted("portbench." + ".".join(p.relative_to(ROOT).with_suffix("").parts)
                 for p in ROOT.rglob("*.py") if "tests" not in p.parts and p.name != "run.py"
                 and p.name != "calibrate.py")
REFERENCE = [m for m in HARNESS if m.startswith("portbench.reference.")]


def _top_level_after(modules, extra=""):
    code = (f"import sys, json, importlib\nsys.path.insert(0, {str(REPO)!r})\n"
            f"for m in {modules!r}: importlib.import_module(m)\n{extra}\n"
            "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    # the harness and the parts of the program a run imports
    found = _top_level_after(HARNESS + ["video_graph_ssl_tpu_torch.train_video_contrast_dis"])
    assert not found & set(FORBIDDEN)
    assert "video_graph_ssl_tpu_torch" in found


def test_the_scripts_load_no_jax():
    for script in ("run.py", "calibrate.py"):
        found = _top_level_after([], f"import runpy; runpy.run_path({str(ROOT / script)!r}, "
                                     "run_name='imported')")
        assert not found & set(FORBIDDEN), script


def test_the_reference_loads_nothing_of_the_program():
    found = _top_level_after(REFERENCE)
    assert "video_graph_ssl_tpu_torch" not in found and not found & set(FORBIDDEN)


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "video_graph_ssl_tpu_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxlike", object())
    assert forbidden_modules() == sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))
    monkeypatch.setitem(sys.modules, "video_graph_ssl_tpu.ops", object())
    assert "video_graph_ssl_tpu" in forbidden_modules()


def test_harness_sources_name_no_jax():
    for path in ROOT.rglob("*.py"):
        if "tests" in path.parts:
            continue
        text = Path(path).read_text()
        assert "import jax" not in text and "from jax" not in text, path
        assert "video_graph_ssl_tpu." not in text.replace("video_graph_ssl_tpu_torch.", ""), path
