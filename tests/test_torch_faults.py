"""The port's fault injector (grove_tpu_torch/faults) against the JAX
package's (grove_tpu/faults): for every case the same specs and seed fire
the same sequence in both, and the port's behaviour matches the JAX tests'
(tests/test_faults.py): the per-site schedule is deterministic and
independent of interleaving, the count/after/rate edges, the raise kinds
and the timeout, the GROVE_FAULTS parser and from_config (the env var
wins), fires journaled as action records, the process-installed injector
kept apart from the JAX package's, the recorder surviving an injected
ENOSPC, and every site the port's modules evaluate exercised by a test.
"""

from __future__ import annotations

import pathlib
from types import SimpleNamespace

import pytest

from grove_tpu import faults as r_faults
from grove_tpu_torch import faults as p_faults

PKGS = {"jax": r_faults, "port": p_faults}
# The sites the port's modules evaluate (solver/drain.py, trace/recorder.py).
PORT_SITES = ("solver.dispatch", "solver.harvest", "recorder.write")


@pytest.fixture(autouse=True)
def _clean_injectors():
    yield
    r_faults.install(None)
    p_faults.install(None)


def fires(mod, specs: dict, seed: int, calls) -> list:
    """Evaluate `calls` (site names, in order) on a fresh injector of `mod`:
    the sites that fired, in order (None where nothing fired)."""
    inj = mod.FaultInjector({s: mod.SiteSpec(**kw) for s, kw in specs.items()}, seed=seed)
    return [site if inj.should_fire(site) is not None else None for site in calls]


@pytest.mark.parametrize("seed", [0, 7, 20260804])
@pytest.mark.parametrize("rate", [0.1, 0.5, 0.9])
def test_fire_sequence_equals_jax(seed, rate):
    specs = {"a.site": {"rate": rate}, "b.site": {"rate": rate, "count": 5, "after": 3}}
    calls = ["a.site", "b.site", "a.site"] * 40
    want = fires(r_faults, specs, seed, calls)
    assert fires(p_faults, specs, seed, calls) == want
    assert any(want)


def test_site_schedule_deterministic_and_interleaving_independent():
    spec = {"a.site": p_faults.SiteSpec(rate=0.5), "b.site": p_faults.SiteSpec(rate=0.5)}
    inj1 = p_faults.FaultInjector(dict(spec), seed=7)
    pattern1 = [inj1.should_fire("a.site") is not None for _ in range(64)]
    inj2 = p_faults.FaultInjector(dict(spec), seed=7)
    pattern2 = []
    for i in range(64):
        if i % 3 == 0:
            inj2.should_fire("b.site")  # interleaved traffic on another site
        pattern2.append(inj2.should_fire("a.site") is not None)
    assert pattern1 == pattern2
    assert any(pattern1) and not all(pattern1)
    inj3 = p_faults.FaultInjector(dict(spec), seed=8)
    assert [inj3.should_fire("a.site") is not None for _ in range(64)] != pattern1
    want = fires(r_faults, {"a.site": {"rate": 0.5}}, 7, ["a.site"] * 64)
    assert [s is not None for s in want] == pattern1


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_count_after_and_rate_edges(pkg):
    mod = PKGS[pkg]
    inj = mod.FaultInjector({"s": mod.SiteSpec(rate=1.0, count=2, after=3)}, seed=0)
    got = [inj.should_fire("s") is not None for _ in range(10)]
    assert got == [False, False, False, True, True, False, False, False, False, False]
    assert inj.fired["s"] == 2 and inj.evaluated["s"] == 10
    never = mod.FaultInjector({"s": mod.SiteSpec(rate=0.0)}, seed=0)
    assert all(never.should_fire("s") is None for _ in range(32))
    assert inj.should_fire("unknown.site") is None


def test_stats_equal_jax():
    docs = []
    for mod in (r_faults, p_faults):
        inj = mod.FaultInjector({"s": mod.SiteSpec(rate=0.5, count=2, after=3),
                                 "t": mod.SiteSpec(kind="timeout")}, seed=11)
        for _ in range(10):
            inj.should_fire("s")
        inj.maybe_timeout("t")
        docs.append(inj.stats())
    assert docs[0] == docs[1]
    assert docs[1]["sites"]["s"]["evaluated"] == 10 and docs[1]["enabled"]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_maybe_raise_kinds(pkg):
    mod = PKGS[pkg]
    inj = mod.FaultInjector({
        "e": mod.SiteSpec(kind="error"),
        "n": mod.SiteSpec(kind="enospc"),
        "d": mod.SiteSpec(kind="disconnect"),
        "h": mod.SiteSpec(kind="http503"),
    }, seed=0)
    with pytest.raises(mod.InjectedFault) as ei:
        inj.maybe_raise("e")
    assert (ei.value.site, ei.value.kind) == ("e", "error")
    with pytest.raises(OSError) as ei:
        inj.maybe_raise("n")
    assert ei.value.errno == 28  # ENOSPC
    with pytest.raises(OSError):
        inj.maybe_raise("d")

    class Fake(RuntimeError):
        def __init__(self, status):
            self.status = status

    with pytest.raises(Fake) as hi:
        inj.maybe_raise("h", exc_factory=Fake)
    assert hi.value.status == 503
    inj.maybe_raise("not.a.site")  # spec-less: a no-op


def test_injected_fault_is_the_ports_own_type():
    assert p_faults.InjectedFault is not r_faults.InjectedFault
    assert issubclass(p_faults.InjectedFault, RuntimeError)
    assert p_faults.SITES == r_faults.SITES and p_faults.KINDS == r_faults.KINDS


@pytest.mark.parametrize("kind,count", [("timeout", 1), ("error", 2), ("enospc", 1)])
def test_maybe_timeout_equals_jax(kind, count):
    got = []
    for mod in (r_faults, p_faults):
        inj = mod.FaultInjector({"t": mod.SiteSpec(kind=kind, count=count)}, seed=0)
        got.append([inj.maybe_timeout("t") for _ in range(4)])
    assert got[0] == got[1]
    if kind == "timeout":
        assert got[1] == [True, False, False, False]  # count exhausted
    if kind == "enospc":
        assert got[1] == [False] * 4  # fires, but is no timeout


def test_fires_are_journaled_as_action_records():
    captured = {"jax": [], "port": []}

    def recorder(out):
        return SimpleNamespace(
            capture_action=lambda now, action, obj, **f: out.append((now, action, obj, f)))

    for pkg, mod in PKGS.items():
        inj = mod.FaultInjector({"solver.dispatch": mod.SiteSpec(count=2)}, seed=0,
                                recorder=recorder(captured[pkg]), clock=lambda: 123.0)
        for _ in range(5):
            inj.should_fire("solver.dispatch", wave=9)
        assert inj.total_fired() == 2
        assert inj.stats()["sites"]["solver.dispatch"]["fired"] == 2
    assert captured["port"] == captured["jax"]
    now, action, obj, fields = captured["port"][0]
    assert (now, action, obj) == (123.0, "fault.injected", "solver.dispatch")
    assert fields == {"faultKind": "error", "wave": 9}


def test_a_failing_recorder_never_blocks_injection():
    def boom(*a, **k):
        raise RuntimeError("tracing is down")

    inj = p_faults.FaultInjector({"s": p_faults.SiteSpec()}, seed=0,
                                 recorder=SimpleNamespace(capture_action=boom))
    assert inj.should_fire("s") is not None


def test_install_is_separate_from_the_jax_package():
    assert p_faults.active().enabled is False
    inj = p_faults.FaultInjector({"s": p_faults.SiteSpec()}, seed=1)
    assert p_faults.install(inj) is inj
    assert p_faults.active() is inj
    assert r_faults.active().enabled is False  # the JAX package's own global
    p_faults.install(None)
    assert p_faults.active().enabled is False


@pytest.mark.parametrize("value", [
    "seed=9;solver.dispatch=error:0.5:3;recorder.write=enospc:1:2:4",
    "solver.harvest=timeout",
    "seed=3; ;solver.dispatch=:0.25::2",
])
def test_parse_env_equals_jax(value):
    specs, seed = p_faults.parse_env(value)
    r_specs, r_seed = r_faults.parse_env(value)
    assert seed == r_seed
    assert {k: tuple(vars(v).values()) for k, v in specs.items()} == \
        {k: tuple(vars(v).values()) for k, v in r_specs.items()}


def test_parse_env_syntax_and_errors():
    specs, seed = p_faults.parse_env(
        "seed=9;solver.dispatch=error:0.5:3;recorder.write=enospc:1:2:4")
    assert seed == 9
    assert specs["solver.dispatch"] == p_faults.SiteSpec("error", 0.5, 3, 0)
    assert specs["recorder.write"] == p_faults.SiteSpec("enospc", 1.0, 2, 4)


@pytest.mark.parametrize("bad", ["nonsense", "s=notakind:1", "s=error:2.0", "s=error:0.5:-1"])
def test_parse_env_errors(bad):
    for mod in (r_faults, p_faults):
        with pytest.raises(ValueError):
            mod.parse_env(bad)


def test_from_config_env_wins_over_config():
    cfg = SimpleNamespace(enabled=True, seed=1, sites={"solver.dispatch": {"rate": 1.0}})
    inj = p_faults.from_config(cfg, env="")
    assert inj is not None and set(inj.specs) == {"solver.dispatch"} and inj.seed == 1
    inj2 = p_faults.from_config(cfg, env="seed=5;recorder.write=enospc:1")
    assert inj2 is not None and set(inj2.specs) == {"recorder.write"} and inj2.seed == 5
    assert p_faults.from_config(SimpleNamespace(enabled=False, seed=0, sites={}), env="") is None
    assert p_faults.from_config(None, env="") is None
    assert p_faults.from_config(SimpleNamespace(enabled=True, seed=0, sites={}), env="") is None


def test_from_config_reads_the_env_var(monkeypatch):
    monkeypatch.setenv("GROVE_FAULTS", "seed=4;solver.harvest=timeout:1:1")
    cfg = SimpleNamespace(enabled=True, seed=1, sites={"solver.dispatch": {}})
    inj = p_faults.from_config(cfg)
    assert set(inj.specs) == {"solver.harvest"} and inj.seed == 4
    assert inj.specs["solver.harvest"] == p_faults.SiteSpec("timeout", 1.0, 1, 0)


@pytest.mark.parametrize("bad", [
    {"kind": "bogus"}, {"rate": 1.5}, {"rate": True}, {"count": -1}, {"after": 1.5},
    {"unknownField": 1}, "not-a-mapping",
])
def test_parse_spec_entry_validation(bad):
    for mod in (r_faults, p_faults):
        with pytest.raises(ValueError):
            mod.parse_spec_entry("s", bad)


def test_parse_spec_entry_equals_jax():
    doc = {"kind": "timeout", "rate": 0.25, "count": 2, "after": 1}
    assert p_faults.parse_spec_entry("s", doc) == p_faults.SiteSpec("timeout", 0.25, 2, 1)
    assert tuple(vars(p_faults.parse_spec_entry("s", doc)).values()) == \
        tuple(vars(r_faults.parse_spec_entry("s", doc)).values())


def test_recorder_survives_enospc_in_counting_drops_mode(tmp_path):
    """An injected segment-write failure (the `recorder.write` site, read
    from the port's installed injector) drops and counts that segment,
    latches `degraded` until a later write succeeds, and stamps the episode
    into the later segments."""
    from grove_tpu_torch.trace.recorder import TraceRecorder, journal_stats

    p_faults.install(p_faults.FaultInjector(
        {"recorder.write": p_faults.SiteSpec(kind="enospc", count=1)}, seed=0))
    rec = TraceRecorder(str(tmp_path / "j"), max_records_per_file=4)
    rec.start()
    try:
        for k in range(4):
            rec.capture_action(float(k), "probe", f"obj-{k}")
        assert rec.flush()
        assert rec.write_errors == 1 and rec.dropped >= 4 and rec.degraded is True
        for k in range(6):
            rec.capture_action(10.0 + k, "probe2", f"obj-{k}")
        assert rec.flush()
        assert rec.degraded is False  # a later write succeeded
    finally:
        rec.stop()
    js = journal_stats(str(tmp_path / "j"))
    assert js["writeErrors"] == 1 and js["degraded"] is True and js["dropped"] >= 4
    assert rec.stats()["writeErrors"] == 1


def test_the_jax_injector_does_not_reach_the_ports_recorder(tmp_path):
    from grove_tpu_torch.trace.recorder import TraceRecorder

    r_faults.install(r_faults.FaultInjector(
        {"recorder.write": r_faults.SiteSpec(kind="enospc")}, seed=0))
    rec = TraceRecorder(str(tmp_path / "j"), max_records_per_file=4)
    rec.start()
    try:
        rec.capture_action(0.0, "probe", "obj")
        assert rec.flush()
    finally:
        rec.stop()
    assert rec.write_errors == 0


def test_bench_enospc_probe():
    from grove_tpu_torch.bench import recorder_enospc_probe

    out = recorder_enospc_probe()
    assert out["survived"] and out["degraded_latched"] and out["degraded_cleared"]
    assert out["write_errors"] == 1 and out["dropped"] == 4
    assert p_faults.active().enabled is False


def test_every_port_fault_site_is_exercised_by_the_suite():
    """Every site the port's modules evaluate is evaluated in the port's
    source and injected by another test of the port or by the port's bench
    gates (the JAX suite's coverage lint): a site nobody injects can rot
    silently."""
    root = pathlib.Path(__file__).resolve().parent.parent
    tests = "".join(p.read_text() for p in sorted((root / "tests").glob("test_torch_*.py"))
                    if p.name != "test_torch_faults.py")
    tests += (root / "grove_tpu_torch" / "bench.py").read_text()
    source = "".join(p.read_text() for p in sorted((root / "grove_tpu_torch").rglob("*.py"))
                     if "faults" not in p.parts)
    for site in PORT_SITES:
        assert site in p_faults.SITES
        assert f'"{site}"' in source, f"{site} is not evaluated by the port"
        assert f'"{site}"' in tests, f"{site} is not injected by a test or the bench"


def test_bench_installs_the_grove_faults_injector(monkeypatch, capsys):
    from grove_tpu_torch import bench

    monkeypatch.setenv("GROVE_FAULTS", "seed=3;solver.harvest=timeout:1:2")
    seen = []
    monkeypatch.setattr(bench, "run_defrag_bench",
                        lambda *a, **k: seen.append(p_faults.active()) or {})
    assert bench.main(["--scenario", "defrag", "--device", "cpu"]) == 0
    inj = seen[0]
    assert inj.enabled and inj.seed == 3
    assert inj.specs == {"solver.harvest": p_faults.SiteSpec("timeout", 1.0, 2, 0)}
    assert capsys.readouterr().out.strip() == "{}"
