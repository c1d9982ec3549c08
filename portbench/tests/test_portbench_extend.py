"""A cell, a traffic mix, a driver and a per-layer metric added as files in
a directory of their own, with no edit to a harness file."""

import importlib.util
import json
import time

from portbench.core.cells import ROOT, load_driver, resolve

DRIVER = '''
from dataclasses import dataclass
from typing import Callable, Optional


@dataclass
class Opts:
    seed: int
    seconds: float
    trace: bool
    t_start: float
    device: str = "cuda"
    wrap_step: Optional[Callable] = None


def run(cell, opts):
    summary = {"busy_s": 0.5, "window_s": 1.0, "breakdown": {"device_ops": [], "idle_gaps": []},
               "rate": cell.settings["X.RATE"]}
    return {"steps": 4, "window_s": 1.0, "failed": 0, "peak_bytes": 1, "forbidden": [],
            "numbers": {"gap": (0.5, "all")}, "summary": summary,
            "metrics": {"ops_per_s": cell.settings["X.RATE"], "setup_s": 2.0}}
'''


def _write(root, rel, text):
    path = root / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text if isinstance(text, str) else json.dumps(text))


def test_a_cell_added_as_files(tmp_path, capsys):
    _write(tmp_path, "configs/dummy.json", {"source": "https://example.org", "reduced": [],
                                            "settings": {"X.RATE": 7.0}})
    _write(tmp_path, "traffic/flat.json", {"driver": "dummy_driver", "settings": {}})
    _write(tmp_path, "drivers/dummy_driver.py", DRIVER)
    _write(tmp_path, "metrics/rate_share.py", "def read(summary):\n    return summary['rate'] / 2\n")
    _write(tmp_path, "metrics/silent.py", "def read(summary):\n    return None\n")
    _write(tmp_path, "limits/dummy.flat.json", {"numbers": {"gap": {"lower": 0.1, "limit": 1.0,
                                                                    "upper": 5.0}}})
    bench = {"workloads": [{"name": "dummy.flat", "config": "dummy", "traffic": "flat",
                            "chips": 1, "why": "x"}],
             "end_to_end": [{"name": "ops_per_s", "unit": "ops/s", "better": "higher",
                             "bound": 0.05, "source": "host_clock"},
                            {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
                             "source": "host_clock"}],
             "per_layer": [{"name": "rate_share", "unit": "%", "better": "higher",
                            "source": "host_clock", "layer": "x", "moves": "ops_per_s"},
                           {"name": "silent", "unit": "%", "better": "higher",
                            "source": "host_clock", "layer": "x", "moves": "ops_per_s"}]}
    _write(tmp_path, "BENCHMARK.json", bench)
    cell = resolve("dummy.flat", root=tmp_path, benchmark=tmp_path / "BENCHMARK.json")
    driver = load_driver(cell)
    spec = importlib.util.spec_from_file_location("portbench_run_extend", ROOT / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    lines = []
    for trace in (False, True):
        opts = driver.Opts(seed=1, seconds=1.0, trace=trace, t_start=time.perf_counter())
        assert run.report(cell, driver, opts, trace,
                          lambda n: {"platform": "gpu", "kind": "fake", "count": n}) == 0
        lines.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    assert lines[0]["correct"] is True
    assert lines[0]["metrics"] == {"ops_per_s": {"value": 7.0, "unit": "ops/s"},
                                   "setup_s": {"value": 2.0, "unit": "s"}}
    # a reader that finds nothing to read leaves its metric out of the line
    assert lines[1]["metrics"] == {"rate_share": {"value": 3.5, "unit": "%"}}
    assert lines[1]["device"]["busy_s"] == 0.5 and "breakdown" in lines[1]
