"""The port's ``utils/profiler.py`` against the JAX package's, on the CPU:
``MetricsLog`` writes the same JSON lines (``ts`` first, then the fields
in order; to a file, appended, or to stdout), ``StageTimer`` keeps the
same counts, means and print-every-X lines, and ``trace`` writes a
Chrome trace of a ``torch.profiler`` window into its directory.
"""

import json

import torch

from perception_tpu.utils import profiler as jprof
from perception_tpu_torch.utils import profiler as tprof


def test_metrics_log_lines_match(tmp_path, capsys):
    rows = [dict(frame=1, fitness=0.25, promoted=True), dict(metric="ate_rmse_m", value=0.01, frames=8)]
    for mod, name in ((tprof, "t.jsonl"), (jprof, "j.jsonl")):
        log = mod.MetricsLog(str(tmp_path / name))
        for r in rows:
            log.emit(**r)
        log.close()
        mod.MetricsLog().emit(**rows[0])
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    lines = {n: [json.loads(x) for x in (tmp_path / n).read_text().splitlines()] for n in ("t.jsonl", "j.jsonl")}
    for got, want in [(lines["t.jsonl"], lines["j.jsonl"]), (printed[:1], printed[1:])]:
        assert [list(r) for r in got] == [list(r) for r in want]
        assert [{k: v for k, v in r.items() if k != "ts"} for r in got] == \
               [{k: v for k, v in r.items() if k != "ts"} for r in want]
    assert list(lines["t.jsonl"][0])[0] == "ts"


def test_stage_timer_counts_and_prints(capsys):
    timers = {"port": tprof.StageTimer(print_every=2), "jax": jprof.StageTimer(print_every=2)}
    for name, timer in timers.items():
        for _ in range(4):
            with timer.stage("a", result=torch.ones(3) if name == "port" else None):
                pass
            with timer.stage("b") as out:
                out["result"] = [torch.zeros(2)] if name == "port" else None
    out = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in out[:4]] == [line.split(":")[0] for line in out[4:]]
    assert dict(timers["port"].count) == dict(timers["jax"].count) == {"a": 4, "b": 4}
    assert set(timers["port"].summary()) == {"a", "b"}


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path / "trace")):
        torch.ones(64).cumsum(0)
    doc = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert doc["traceEvents"]
