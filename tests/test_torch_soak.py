"""The port's soak harnesses (redisson_tpu_torch/chaos/soak.py) against the
reference's (redisson_tpu/chaos/soak.py), on the CPU: the same fault
schedules from the same seeds, the same config fields and defaults (plus
``device`` and ``positions``), byte-equal summaries for equal reports, the
device reaching every server, runner, supervisor and embedded client a
harness builds, the no-card error, the standard profile's mesh positions,
and the soak_smoke tool.  The harnesses' own runs are the reference's
tests/test_soak.py and the soak tests of the suite runners."""
import ast
import dataclasses
import os
import subprocess
import sys

import pytest
import torch

from redisson_tpu.chaos import soak as ref_soak
from redisson_tpu_torch.chaos import soak as port_soak
from redisson_tpu_torch.core import engine as port_engine
from redisson_tpu_torch.parallel import mesh as TM
from redisson_tpu_torch.parallel.manager import MeshManager

TM.set_cpu_positions(8)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROFILES = ("Soak", "MigrationSoak", "ClusterProcSoak", "FleetSoak", "HostFleetSoak",
            "TrackingSoak", "ReadScaleSoak", "DeviceShardSoak", "DeviceFaultSoak",
            "QosSoak", "VectorSoak", "ResidencySoak")
# the configs that place state on mesh positions
PLACED = ("Soak", "DeviceShardSoak", "DeviceFaultSoak", "VectorSoak", "ResidencySoak")


def _faults(sched):
    return [dataclasses.asdict(f) for f in sched.faults]


# -- the schedules ----------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("cycle", range(3))
def test_default_schedule_equals_the_references(seed, cycle):
    ref = ref_soak.SoakHarness._default_schedule(ref_soak.SoakConfig(seed=seed), cycle)
    port = port_soak.SoakHarness._default_schedule(port_soak.SoakConfig(seed=seed), cycle)
    assert _faults(port) == _faults(ref) and _faults(ref)


@pytest.mark.parametrize("profile", ("FleetSoak", "HostFleetSoak", "MigrationSoak"))
@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("cycle", range(3))
def test_transport_schedule_equals_the_references(profile, seed, cycle):
    def schedule(mod):
        harness = getattr(mod, f"{profile}Harness")(getattr(mod, f"{profile}Config")(seed=seed))
        return _faults(harness._transport_schedule(cycle))

    assert schedule(port_soak) == schedule(ref_soak) != []


# -- the configs and reports ------------------------------------------------


def _defaults(cls):
    out = {}
    for f in dataclasses.fields(cls):
        out[f.name] = f.default_factory() if f.default_factory is not dataclasses.MISSING else f.default
    return out


@pytest.mark.parametrize("profile", PROFILES)
def test_config_has_the_references_fields_and_defaults(profile):
    ref = _defaults(getattr(ref_soak, f"{profile}Config"))
    port = _defaults(getattr(port_soak, f"{profile}Config"))
    extra = {"device": "cuda", **({"positions": None} if profile in PLACED else {})}
    assert [k for k in port if k not in extra] == list(ref)
    assert set(port) == set(ref) | set(extra)
    assert {k: port[k] for k in ref} == ref
    assert {k: port[k] for k in extra} == extra


def _filled(cls, salt: int):
    """A report of `cls` with every field set to a value of its type."""
    values = {}
    for i, f in enumerate(dataclasses.fields(cls)):
        v = salt * 31 + i
        default = f.default_factory() if f.default_factory is not dataclasses.MISSING else f.default
        if isinstance(default, float):
            values[f.name] = v + 0.375
        elif isinstance(default, int):
            values[f.name] = v
        elif isinstance(default, dict):
            values[f.name] = {"delay": v, "drop": v + 1}
        elif isinstance(default, list):
            values[f.name] = [("10.0.0.1:7000", "10.0.0.2:7001"), {"k": float(v)}][: 1 + v % 2]
        else:
            raise AssertionError(f"{cls.__name__}.{f.name}: {default!r}")
    return values


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("salt", (0, 1))
def test_equal_reports_give_byte_equal_summaries(profile, salt):
    ref_cls = getattr(ref_soak, f"{profile}Report")
    port_cls = getattr(port_soak, f"{profile}Report")
    assert [f.name for f in dataclasses.fields(port_cls)] == [f.name for f in dataclasses.fields(ref_cls)]
    assert _defaults(port_cls) == _defaults(ref_cls)
    values = _filled(ref_cls, salt)
    assert port_cls(**values).summary() == ref_cls(**values).summary()
    assert port_cls().summary() == ref_cls().summary()


# -- the device --------------------------------------------------------------


@pytest.fixture()
def engines(monkeypatch):
    """The device of every Engine made while the fixture is live."""
    made = []
    init = port_engine.Engine.__init__

    def recording(self, *a, **k):
        init(self, *a, **k)
        made.append(self.device)

    monkeypatch.setattr(port_engine.Engine, "__init__", recording)
    return made


IN_PROCESS = ("Soak", "MigrationSoak", "TrackingSoak", "ReadScaleSoak", "DeviceShardSoak",
              "DeviceFaultSoak", "QosSoak", "VectorSoak", "ResidencySoak")


@pytest.mark.parametrize("profile", IN_PROCESS)
def test_cpu_device_reaches_every_server_and_client(profile, engines):
    h = getattr(port_soak, f"{profile}Harness")(getattr(port_soak, f"{profile}Config")(device="cpu"))
    try:
        h._setup()
        if profile == "MigrationSoak":
            h._checkpoint_chaos(0)  # its fresh create() loads the checkpoint
        runner = getattr(h, "_runner", None)
        nodes = runner.masters + runner.replicas if runner is not None else []
        servers = [n.server.server for n in nodes] + ([h._server.server] if getattr(h, "_server", None) else [])
        assert servers
        assert all(s.engine.device.type == "cpu" for s in servers)
        if profile == "Soak":
            assert h._embedded is not None and h._embedded._engine.device.type == "cpu"
    finally:
        h._teardown()
    want = len(servers) + (profile in ("Soak", "MigrationSoak"))
    assert len(engines) >= want and all(d.type == "cpu" for d in engines), engines


@pytest.mark.parametrize("profile", ("ClusterProcSoak", "FleetSoak", "HostFleetSoak"))
def test_cpu_device_reaches_the_supervisor(profile, monkeypatch):
    monkeypatch.delenv("RTPU_PROC_PLATFORM", raising=False)
    h = getattr(port_soak, f"{profile}Harness")(getattr(port_soak, f"{profile}Config")(device="cpu"))
    sup = h._make_supervisor()
    try:
        assert sup.platform == "cpu"
    finally:
        sup.shutdown()
    # the environment still overrides the config's device
    monkeypatch.setenv("RTPU_PROC_PLATFORM", "cpu")
    h = getattr(port_soak, f"{profile}Harness")(getattr(port_soak, f"{profile}Config")())
    sup = h._make_supervisor()
    try:
        assert sup.platform == "cpu"
    finally:
        sup.shutdown()


@pytest.mark.parametrize("profile", PROFILES)
def test_default_device_without_a_card_raises(profile, monkeypatch, engines):
    if torch.cuda.is_available():
        pytest.skip("holds the no-card error: this machine has a card")
    monkeypatch.delenv("RTPU_PROC_PLATFORM", raising=False)
    h = getattr(port_soak, f"{profile}Harness")()
    assert h.config.device == "cuda"
    try:
        with pytest.raises(RuntimeError, match="CUDA card by default and none is available"):
            h._setup()
    finally:
        h._teardown()
    assert engines == []  # nothing was built on the CPU instead
    if profile in ("ClusterProcSoak", "FleetSoak", "HostFleetSoak"):
        assert h._sup is None  # no child process was spawned


# -- positions ---------------------------------------------------------------


@pytest.mark.parametrize("positions", (None, 8))
def test_standard_profile_positions(positions):
    """positions=8 shards the embedded bloom array over 8 positions even
    where the CPU has one; None takes the local positions (one here), too
    few for the reshard, so no embedded client is made."""
    prev = TM.set_cpu_positions(1)
    h = port_soak.SoakHarness(port_soak.SoakConfig(
        device="cpu", positions=positions, masters=1, replicas_per_master=0, bloom_batch=64))
    try:
        h._setup()
        if positions is None:
            assert h._embedded is None
            return
        mesh = MeshManager.of(h._embedded._engine).mesh
        assert mesh.shape == {"dp": 2, "shard": 4}
        assert sorted(p.id for p in mesh.devices.flat) == list(range(8))
        rec = h._embedded._engine.store.get("soak:bloom")
        assert rec.arrays["bits"].parts.shape == (2, 4)
        h._bloom_phase()  # 4 -> 8 -> 4, every acked add found
        assert h.report.bloom_keys_verified == 2 * 64
    finally:
        h._teardown()
        TM.set_cpu_positions(prev)


# -- the tool ----------------------------------------------------------------


def test_soak_smoke_tool_migration_profile_on_the_cpu():
    env = {k: v for k, v in os.environ.items() if k != "RTPU_PROC_PLATFORM"}
    out = subprocess.run(
        [sys.executable, "-m", "redisson_tpu_torch.tools.soak_smoke", "--profile", "migration",
         "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240,
    )
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "SOAK OK" and lines[-2].startswith("migration soak: 1 cycles")


def test_soak_smoke_tool_takes_the_references_profiles():
    from redisson_tpu_torch.tools import soak_smoke

    with open(os.path.join(REPO, "tools", "soak_smoke.py")) as f:
        tree = ast.parse(f.read())
    choices = [ast.literal_eval(k.value) for node in ast.walk(tree) if isinstance(node, ast.Call)
               for k in node.keywords if k.arg == "choices"]
    assert len(choices) == 1 and len(choices[0]) == 12
    assert sorted(soak_smoke.PROFILES) == sorted(choices[0])
