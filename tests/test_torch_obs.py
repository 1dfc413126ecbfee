"""The port's observability package (``repro_torch.obs``) against the
reference's (``repro.obs``), and the port's import rule.

A scripted sequence of sink and registry calls (every event kind of
schema v4: stages, nested spans, solver counters, device and round
records, faults, monitor warnings, profiles, metrics snapshots) is
written once by each package.  Each package reads the other's trace to
the same summary; the registries render the same Prometheus text; the
port's ``export``, ``diff`` and ``dash`` (and its CLI) turn a trace the
reference wrote into the bytes the reference's modules produce — the
dashboard's footer names the tool that wrote it, and is the one line
that differs.
"""
import ast
import io
import json
import time
from contextlib import redirect_stdout
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro import obs as jobs  # noqa: E402
from repro.obs import __main__ as jmain  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.obs import __main__ as pmain  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _reset_port_obs_defaults():
    """The port's process-wide sink and registry, reset after every
    test (the shared conftest resets only the reference's)."""
    yield
    obs.set_default(None)
    obs.metrics.set_default(None)


def _script(o, path, rounds=3, skew=0.0):
    """Drive package ``o``'s sink and registry through ``rounds`` rounds
    of every event kind; ``skew`` stretches one stage (for diffs)."""
    tele = o.Telemetry(path=path, meta={"source": "test"})
    reg = o.Registry()
    o.metrics.set_default(reg)
    for i in range(rounds):
        tele.begin_round(i)
        with tele.span("round"):
            with tele.stage("data"):
                pass
            with tele.stage("sigma"):
                time.sleep(0.001)
            with tele.stage("matching"):
                with tele.span("matching.init"):
                    pass
                for sweep in (1, 2):
                    with tele.span("matching.sweep", sweep=sweep):
                        pass
            with tele.stage("power"):
                for it in range(2):
                    with tele.span("power.ccp_iter", iter=it):
                        time.sleep(skew)
            with tele.stage("selection"):
                with tele.span("selection.gp", steps=20):
                    pass
                with tele.span("selection.recover"):
                    pass
            with tele.stage("objective"):
                pass
            with tele.stage("local_grads"):
                with tele.span("device.upload", device=1, tau_s=0.5):
                    pass
            with tele.stage("aggregate"):
                pass
            tele.solver("power", method="closed_form", feasible=True)
            tele.solver("matching", swaps=i, sweeps=2, rb_evals=30 + i,
                        unmatched=0, feasible=i != 1, mode="scalar")
            tele.solver("selection", method="faithful", gp_steps=20,
                        n_selected=17 + i)
            if i == 1:
                tele.fault("dropout", injected=True, device=2)
                tele.fault("fallback", injected=False, solver="power",
                           to="closed_form", reason="infeasible")
            tele.devices(energy_cmp_j=[1e-8, 2e-8], energy_com_j=[3e-5, 0.0],
                         cost=[0.1, 0.2], reward=[0.01 * i, 0.03],
                         selected=[3, 4 + i], uploaded=[1, 0],
                         mislabel_frac=[0.0, 0.25])
            tele.round_end(wall_s=0.01 * (i + 1), net_cost=-0.5 + 0.1 * i,
                           delta_obj=123.0 / (i + 1), n_selected=7 + i,
                           n_uploaded=1, feasible=i != 1,
                           test_acc=None if i else 0.5)
            tele.emit(o.MonitorEvent(kind="bound_violation", value=1.2,
                                     threshold=1.1, round=i,
                                     detail={"bound": 1.0}))
            reg.counter("feel_rounds_total", "completed FEEL rounds").inc()
            reg.counter("feel_power_calls_total", "power allocations").inc(
                2, method="closed_form")
            reg.gauge("feel_monitor_bound_gap_ratio", "gap / bound").set(
                0.9 + 0.1 * i)
            reg.histogram("feel_round_wall_seconds", "wall").observe(
                0.01 * (i + 1))
            if i == 0:
                tele.emit(o.ProfileEvent(name="sigma_all", stage="sigma",
                                         flops=1.5e6, bytes_accessed=2.5e5,
                                         peak_flops=1e12, compile_s=0.1,
                                         round=0))
            tele.emit(reg.snapshot_event(round=i))
    tele.close()
    o.metrics.set_default(None)
    return tele


def _strip_times(records):
    drop = {"t0_s", "dur_s", "t_s", "wall_s", "families"}
    return [{k: v for k, v in r.items() if k not in drop} for r in records]


def test_sink_round_trip(tmp_path):
    path = str(tmp_path / "t.jsonl")
    tele = _script(obs, path)
    recs = obs.load_trace(path)
    assert recs[0] == {"ev": "header", "v": obs.SCHEMA_VERSION,
                       "meta": {"source": "test"}}
    assert recs[1:] == [e.to_record() for e in tele.events]
    assert [obs.parse_record(r).to_record() for r in recs[1:]] == recs[1:]
    roots, orphans = obs.build_tree(recs, strict=True)
    assert [r.name for r in roots] == ["round"] * 3 and not orphans
    for root in roots:
        for node in root.walk():
            for c in node.children:
                assert node.t0_s - 1e-6 <= c.t0_s
                assert c.end_s <= node.end_s + 1e-6
    # block hands its argument back; CPU tensors need no wait
    x = {"a": [torch.ones(2)], "b": (torch.zeros(1), 3)}
    assert obs.NULL.block(x) is x and tele.block(x) is x
    assert obs.trace.cuda_devices(x, set()) == set()
    assert obs.NULL.stage("x") is obs.NULL.span("y")


@pytest.mark.parametrize("writer,reader", [(obs, jobs), (jobs, obs)],
                         ids=["port_trace_jax_reader", "jax_trace_port_reader"])
def test_each_package_reads_the_others_trace(writer, reader, tmp_path):
    path = str(tmp_path / "t.jsonl")
    _script(writer, path)
    other = str(tmp_path / "o.jsonl")
    _script(reader, other)
    got = reader.summarize(reader.load_trace(path))
    own = reader.summarize(reader.load_trace(other))
    assert got.n_rounds == own.n_rounds == 3
    assert set(got.stages) == set(own.stages)
    assert {k: s.calls for k, s in got.stages.items()} == \
        {k: s.calls for k, s in own.stages.items()}
    assert got.solvers == own.solvers
    assert got.device_totals == own.device_totals
    assert got.fault_counts == own.fault_counts
    assert got.monitor_counts == own.monitor_counts
    assert got.profiles == own.profiles
    assert _strip_times(reader.load_trace(path)) == \
        _strip_times(reader.load_trace(other))
    assert [n.path() for r in reader.build_tree(reader.load_trace(path),
                                                strict=True)[0]
            for n in r.walk()] == \
        [n.path() for r in reader.build_tree(reader.load_trace(other),
                                             strict=True)[0]
         for n in r.walk()]


def _fill(o):
    """The same instrument calls on a fresh registry of package ``o``."""
    reg = o.Registry()
    for i in range(3):
        reg.counter("feel_rounds_total", "completed FEEL rounds").inc()
        reg.counter("feel_power_calls_total", "power allocations").inc(
            2, method="closed_form")
        reg.gauge("feel_cum_net_cost", "cumulative \"net\" cost").set(
            -0.1 * i)
        reg.histogram("feel_stage_seconds", "stage wall").observe(
            0.003 * (i + 1) ** 3, stage="sigma")
    reg.histogram("feel_x", buckets=(0.5, 1.0)).observe(7.0)
    return reg


def test_registries_render_the_same_exposition(tmp_path):
    jreg, preg = _fill(jobs), _fill(obs)
    assert preg.render() == jreg.render()
    assert preg.snapshot() == jreg.snapshot()
    # each package renders a snapshot of either package byte for byte
    for fams in (jreg.snapshot(), preg.snapshot()):
        fams = json.loads(json.dumps(fams))
        assert obs.render_snapshot(fams) == jobs.render_snapshot(fams) \
            == jreg.render()
    tele = _script(jobs, str(tmp_path / "t.jsonl"))
    fams = [e for e in tele.events if isinstance(e, jobs.MetricsEvent)][-1]
    assert obs.render_snapshot(fams.families) == \
        jobs.render_snapshot(fams.families)


def _run(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def test_tools_on_a_jax_trace_match_the_reference(tmp_path):
    base, head = str(tmp_path / "base.jsonl"), str(tmp_path / "head.jsonl")
    _script(jobs, base)
    _script(jobs, head, skew=0.002)
    recs = jobs.load_trace(base)
    assert obs.to_chrome_trace(recs) == jobs.to_chrome_trace(recs)
    obs.export_file(base, str(tmp_path / "p.json"))
    jobs.export_file(base, str(tmp_path / "j.json"))
    assert (tmp_path / "p.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()
    hrecs = jobs.load_trace(head)
    assert obs.diff_traces(recs, hrecs).render() == \
        jobs.diff_traces(recs, hrecs).render()
    page, want = obs.render_dashboard(recs), jobs.render_dashboard(recs)
    assert page == want.replace("python -m repro.obs dash",
                                "python -m repro_torch.obs dash")
    # the CLIs: same subcommands, same output
    for argv in (["summary", base], [base], ["metrics", base],
                 ["diff", base, head]):
        assert _run(pmain.main, argv) == _run(jmain.main, argv), argv
    out_p, out_j = str(tmp_path / "p2.json"), str(tmp_path / "j2.json")
    _run(pmain.main, ["export", base, "-o", out_p])
    _run(jmain.main, ["export", base, "-o", out_j])
    assert Path(out_p).read_bytes() == Path(out_j).read_bytes()
    _run(pmain.main, ["dash", base, "-o", str(tmp_path / "p.html")])
    assert (tmp_path / "p.html").read_text() == page


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 40
    bad = [(str(f.relative_to(ROOT)), name) for f in files
           for name in _imports(f)
           if name.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []


def test_cost_of_counts_flops_bytes_and_the_kernels_own_work(monkeypatch):
    from repro_torch.kernels import gradnorm

    m, k, n = 6, 5, 4
    a, b = torch.ones(m, k), torch.ones(n, k)
    cost = obs.cost_of(lambda x, y: x @ y.t(), a, b)  # t() is a view
    assert cost["flops"] == 2 * m * n * k
    assert cost["bytes_accessed"] == 4 * (m * k + n * k + m * n)
    assert cost["compile_s"] > 0

    # the kernel is one custom op to both modes: its FLOP formula is its
    # own count, its bytes its inputs and output
    h, dlogits = torch.ones(2000, 84), torch.ones(2000, 10)

    def launches(x):
        gradnorm.gradnorm_sigma(h, dlogits)
        return x + 1

    cost = obs.cost_of(launches, a)
    flops, n_bytes = gradnorm.cost(2000, 84, 10)
    assert (flops, n_bytes) == (2.0 * 2000 * 94 + 2 * 2000,
                                4.0 * (2000 * 94 + 2000))
    assert gradnorm.cost(2000, 84) == (2.0 * 2000 * 84, 4.0 * (2000 * 84
                                                             + 2000))
    assert cost["flops"] == flops
    assert cost["bytes_accessed"] == n_bytes + 2 * 4 * m * k

    monkeypatch.setenv("REPRO_PEAK_FLOPS", "1.5e13")
    assert obs.peak_flops() == 1.5e13
    reg, tele = obs.Registry(), obs.Telemetry()
    prof = obs.profile_fn(lambda x, y: x @ y.t(), (a, b), name="mm",
                          stage="sigma", telemetry=tele, registry=reg,
                          round=0)
    (event,) = tele.events
    assert (event.name, event.stage, event.flops, event.peak_flops) == (
        "mm", "sigma", 2 * m * n * k, 1.5e13)
    assert prof.arithmetic_intensity == prof.flops / prof.bytes_accessed
    assert reg.gauge("feel_kernel_flops").value(kernel="mm") == prof.flops
