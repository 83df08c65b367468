"""The port's planner core against the reference's, on the CPU.

- Decisions: the port's ``Planner`` and the reference's, fed the same
  profile (flat, and a parallelism sweep of two configs), ``SloSpec`` and
  sequence of ``TrafficSample`` s, make the same ``PlanDecision`` s and the
  same connector calls, read through a recording connector, once per load
  predictor. Their correction factors agree too.
- The fleet supervisor: the port's ``LocalConnector`` with the port's
  ``stub_worker_cmd`` counts a worker only once its ``/healthz/ready``
  answers 200, and a drain scale-down is not counted as a crash (the
  reference's suite covers the rest of the same code text).
- The process: ``python -m dynamo_tpu_torch.planner.main --connector local``
  over stub workers scales the prefill pool from 1 to 2 under a load that
  a served ``/metrics`` reports, and back to 1 by a drain once the load
  ends, with no crash counted.
"""

import asyncio
import http.server
import json
import os
import shlex
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

from dynamo_tpu import planner as jplanner
from dynamo_tpu.planner import perf_interpolation as jinterp
from dynamo_tpu.planner import planner_core as jcore
from dynamo_tpu_torch import planner as tplanner
from dynamo_tpu_torch.planner import perf_interpolation as tinterp
from dynamo_tpu_torch.planner import planner_core as tcore
from dynamo_tpu_torch.planner.connectors import LocalConnector
from dynamo_tpu_torch.planner.metrics import get_planner_metrics
from dynamo_tpu_torch.utils.faults import stub_worker_cmd
from tests.procutils import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FLAT = {
    "prefill": [{"isl": 128, "ttft_s": 0.021, "tokens_per_s": 6095.2},
                {"isl": 512, "ttft_s": 0.046, "tokens_per_s": 11130.4},
                {"isl": 2048, "ttft_s": 0.171, "tokens_per_s": 11976.6}],
    "decode": [{"concurrency": 1, "itl_s": 0.0061, "tokens_per_s": 150.0},
               {"concurrency": 8, "itl_s": 0.0083, "tokens_per_s": 910.0},
               {"concurrency": 32, "itl_s": 0.0142, "tokens_per_s": 2100.0}],
}
SWEEP = {"configs": [
    dict(FLAT, tp=1, sp=1, chips=1),
    {"tp": 2, "sp": 1, "chips": 2,
     "prefill": [{"isl": 128, "ttft_s": 0.012, "tokens_per_s": 10666.7},
                 {"isl": 2048, "ttft_s": 0.09, "tokens_per_s": 22755.6}],
     "decode": [{"concurrency": 1, "itl_s": 0.004, "tokens_per_s": 240.0},
                {"concurrency": 32, "itl_s": 0.008, "tokens_per_s": 3800.0}]},
]}
# idle, a ramp with observed latencies and a prefill backlog, a burst,
# then idle again: every branch of decide()
SAMPLES = [
    dict(request_rate=0.0, avg_isl=0.0, avg_osl=0.0),
    dict(request_rate=4.0, avg_isl=512.0, avg_osl=64.0),
    dict(request_rate=12.0, avg_isl=900.0, avg_osl=128.0,
         observed_ttft_s=0.09, observed_itl_s=0.011),
    dict(request_rate=40.0, avg_isl=2048.0, avg_osl=256.0,
         observed_ttft_s=0.5, observed_itl_s=0.03, prefill_queue_depth=6),
    dict(request_rate=25.0, avg_isl=1500.0, avg_osl=200.0,
         observed_ttft_s=0.2),
    dict(request_rate=3.0, avg_isl=300.0, avg_osl=40.0,
         observed_itl_s=0.005),
    dict(request_rate=0.0, avg_isl=0.0, avg_osl=0.0),
]


class Recording:
    def __init__(self):
        self.calls = []

    async def scale(self, prefill, decode, prefill_config=None,
                    decode_config=None):
        self.calls.append((prefill, decode, prefill_config, decode_config))


class ListSource:
    def __init__(self, samples):
        self.samples = list(samples)

    async def sample(self):
        return self.samples.pop(0) if self.samples else None


async def _decisions(core, interp_mod, predictor, profile):
    conn = Recording()
    planner = core.Planner(
        core.PlannerConfig(interval_s=5.0, predictor=predictor,
                           max_prefill=8, max_decode=8),
        core.SloSpec(ttft_s=0.3, itl_s=0.01),
        interp_mod.MultiPerfInterpolator(profile),
        ListSource(core.TrafficSample(**s) for s in SAMPLES), conn)
    out = []
    for _ in SAMPLES:
        d = await planner.step()
        out.append((d.prefill, d.decode, d.predicted_rate, d.prefill_config,
                    d.decode_config, planner.prefill_correction,
                    planner.decode_correction))
    return out, conn.calls


@pytest.mark.parametrize("profile", [FLAT, SWEEP], ids=["flat", "sweep"])
@pytest.mark.parametrize("predictor",
                         ["constant", "ewma", "trend", "seasonal"])
async def test_decisions_match_reference(predictor, profile):
    got = await _decisions(tcore, tinterp, predictor, profile)
    want = await _decisions(jcore, jinterp, predictor, profile)
    assert got == want
    decisions, calls = got
    # the sequence moves the fleet both ways
    assert calls and max(d[0] for d in decisions) > 1
    assert tplanner.__all__ == jplanner.__all__


def fast_connector(prefill_cmd, decode_cmd, **kw):
    """The reference suite's tight supervise / probe cadence."""
    defaults = dict(supervise_interval_s=0.02, probe_interval_s=0.02,
                    backoff_base_s=0.01, backoff_cap_s=0.05,
                    drain_margin_s=0.2)
    defaults.update(kw)
    return LocalConnector(prefill_cmd, decode_cmd, **defaults)


async def test_readiness_gates_counts(monkeypatch):
    monkeypatch.setenv("DYN_DRAIN_TIMEOUT_S", "0.2")
    # the prefill stub answers 503 for 3 s: a python start on a loaded
    # host takes most of a second, so a shorter wait races the decode's
    c = fast_connector(stub_worker_cmd(ready_after_s=3.0), stub_worker_cmd())
    try:
        await c.scale(1, 1)
        assert c.alive_counts() == {"prefill": 1, "decode": 1}
        assert c.counts()["prefill"] == 0
        await c.wait_ready("decode", 1, timeout=10)
        assert c.counts()["prefill"] == 0      # not ready yet
        await c.wait_ready("prefill", 1, timeout=10)
        assert c.counts() == {"prefill": 1, "decode": 1}
    finally:
        await c.close(force=True)


async def test_drain_scale_down_is_not_a_crash(monkeypatch):
    monkeypatch.setenv("DYN_DRAIN_TIMEOUT_S", "0.5")
    crashes = get_planner_metrics().worker_crashes_total.labels("decode")
    before = crashes._value.get()
    c = fast_connector(stub_worker_cmd(), stub_worker_cmd(drain_s=0.05))
    try:
        await c.scale(0, 2)
        await c.wait_ready("decode", 2, timeout=10)
        await c.scale(0, 1)
        await c.quiesce()
        assert c.alive_counts()["decode"] == 1
        assert c.counts()["decode"] == 1
        # drained and exited 0 on request: not a crash, not healed back
        await asyncio.sleep(0.2)
        assert crashes._value.get() == before
        assert c.alive_counts()["decode"] == 1
    finally:
        await c.close(force=True)


class _Frontend(http.server.BaseHTTPRequestHandler):
    """A frontend's /metrics (the frontend's own series names) whose
    request counter the test moves."""

    requests = 0.0

    def log_message(self, *a):
        pass

    def do_GET(self):
        from prometheus_client import (CollectorRegistry, Counter,
                                       generate_latest)
        reg = CollectorRegistry()
        n = type(self).requests
        for name, per in (("requests", 1), ("input_tokens", 1024),
                          ("output_tokens", 8)):
            Counter(f"dynamo_frontend_{name}_total", name, ["model"],
                    registry=reg).labels("m").inc(n * per)
        body = generate_latest(reg)
        self.send_response(200)
        self.send_header("content-type", "text/plain")
        self.end_headers()
        self.wfile.write(body)


def _scrape(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=5) as r:
        text = r.read().decode()
    out = {}
    for line in text.splitlines():
        if line.startswith("dynamo_planner_") and " " in line:
            k, v = line.rsplit(" ", 1)
            out[k] = float(v)
    return out


def test_planner_process_scales_stub_workers(tmp_path):
    """1 -> 2 prefill workers while the served counter grows by 2 requests
    of 1024 tokens a second against a profile of 1600 prefill tokens a
    second per worker (need 2 * 1024 / 1600 * 1.15 = 1.47), back to 1 by
    a drain when it stops."""
    profile = tmp_path / "profile.json"
    profile.write_text(json.dumps({
        "prefill": [{"isl": 128, "ttft_s": 0.08, "tokens_per_s": 1600.0},
                    {"isl": 2048, "ttft_s": 1.28, "tokens_per_s": 1600.0}],
        "decode": [{"concurrency": 1, "itl_s": 0.005, "tokens_per_s": 200.0},
                   {"concurrency": 8, "itl_s": 0.008,
                    "tokens_per_s": 1000.0}]}))
    fe = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Frontend)
    threading.Thread(target=fe.serve_forever, daemon=True).start()
    sys_port = free_port()
    (tmp_path / "logs").mkdir()
    stub = shlex.join(stub_worker_cmd(ready_after_s=0.3, drain_s=0.1))
    env = dict(os.environ, PYTHONPATH=REPO, DYN_SYSTEM_ENABLED="1",
               DYN_SYSTEM_PORT=str(sys_port), DYN_DRAIN_TIMEOUT_S="2")
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.planner.main",
         "--connector", "local", "--profile", str(profile),
         "--metrics-url", f"http://127.0.0.1:{fe.server_port}/metrics",
         "--interval", "0.5", "--predictor", "constant",
         "--max-prefill", "2", "--max-decode", "1",
         "--prefill-cmd", stub, "--decode-cmd", stub,
         "--worker-log-dir", str(tmp_path / "logs")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=REPO,
        start_new_session=True)
    key = 'dynamo_planner_replicas{role="prefill"}'
    seen = []

    def wait_for(pred, what, timeout=30.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                raise AssertionError(proc.stdout.read().decode()[-3000:])
            try:
                m = _scrape(sys_port)
            except OSError:
                m = {}
            if key in m:
                seen.append(m[key])
            if pred(m):
                return m
            time.sleep(0.05)
        raise AssertionError(f"{what}: {seen[-5:]}")

    try:
        wait_for(lambda m: m.get(key) == 1.0
                 and m.get('dynamo_planner_replicas{role="decode"}') == 1.0,
                 "the floor of 1 / 1 ready")
        t0 = time.monotonic()
        while time.monotonic() - t0 < 30 and seen[-1] != 2.0:
            _Frontend.requests = 2.0 * (time.monotonic() - t0)
            wait_for(lambda m: True, "scrape", timeout=5)
            time.sleep(0.05)
        wait_for(lambda m: m.get(key) == 2.0, "two prefill workers")
        m = wait_for(lambda m: m.get(key) == 1.0, "drained back to one")
        assert m['dynamo_planner_decisions_total{action="up"}'] >= 1
        assert m['dynamo_planner_decisions_total{action="down"}'] >= 1
        assert m['dynamo_planner_worker_crashes_total{role="prefill"}'] == 0
        assert m['dynamo_planner_worker_crashes_total{role="decode"}'] == 0
        logs = sorted(os.listdir(tmp_path / "logs"))
        assert logs == ["decode-g2.log", "prefill-g1.log", "prefill-g3.log"]
    finally:
        # SIGINT: the planner closes its connector, which drains the fleet
        proc.send_signal(signal.SIGINT)
        try:
            rc = proc.wait(timeout=20)
        except subprocess.TimeoutExpired:
            rc = None
        try:
            os.killpg(proc.pid, signal.SIGKILL)   # whatever is left of it
        except ProcessLookupError:
            pass
        proc.wait()
        fe.shutdown()
    assert rc == 0
    for h in ("prefill-g1", "decode-g2", "prefill-g3"):
        assert "stub worker up" in (tmp_path / "logs" /
                                     f"{h}.log").read_text()
