"""The port's `config.py` against the JAX package's: the same TOML files,
environment variables and `ALTER SYSTEM SET` values give the same
dataclass fields (`mesh` left out: each package holds its own mesh type)
or the same error. Everything compared is exact (tolerance 0).
"""
import dataclasses

import pytest
import torch

import risingwave_tpu.config as RC
import risingwave_tpu_torch.config as PC

TOMLS = [
    "[streaming]\nchunk_size = 512\ncheckpoint_frequency = 3\n\n"
    "[storage]\nblock_cache_blocks = 128\n",
    "[storage]\ndata_dir = '/tmp/rw'\ncompact_threshold = 2\n",
    "[streaming]\nbarrier_interval_ms = 250\n",
    "",
    "[device]\nmode = 'off'\n",
    "[device]\nmode = 'on'\ncapacity = 4096\nprofile = false\n"
    "aot_compile = false\ncompile_buckets = 0\nhbm_budget_mb = 512\n",
    "[device]\nmode = 'single'\nmesh_shards = 4\nfuse = false\n"
    "compile_cache_dir = '/tmp/cc'\nmv_persist_every = 2\n",
]

BAD_TOMLS = [
    ("[streaming]\nchunk_sz = 1\n", "unknown config key"),
    ("[nonsense]\nx = 1\n", "unknown config sections"),
    ("[storage]\ndata_directory = 'x'\n", "unknown config key"),
    ("[device]\nmode = 'off'\ncapcity = 9\n", "unknown config key"),
    ("[device]\nmode = 'on'\nskew_stats = false\n", "unknown config key"),
]


def fields_of(cfg):
    """A config dataclass as a dict, `mesh` left out, nested ones too."""
    if cfg is None:
        return None
    out = {}
    for f in dataclasses.fields(cfg):
        if f.name == "mesh":
            continue
        v = getattr(cfg, f.name)
        out[f.name] = fields_of(v) if dataclasses.is_dataclass(v) else v
    return out


@pytest.mark.parametrize("text", TOMLS)
def test_node_config_from_toml(tmp_path, text):
    p = tmp_path / "rw.toml"
    p.write_text(text)
    ref = RC.NodeConfig.from_toml(str(p))
    got = PC.NodeConfig.from_toml(str(p))
    assert fields_of(got) == fields_of(ref)
    assert got.streaming.barrier_interval_ms == \
        ref.streaming.barrier_interval_ms
    assert (got.device is None) == (ref.device is None)
    if got.device is not None:
        assert got.device.mesh is None and ref.device.mesh is None


@pytest.mark.parametrize("text,match", BAD_TOMLS)
def test_node_config_rejects_unknown_keys(tmp_path, text, match):
    """Typos fail at startup in both packages, a device section's too
    even when the device is off."""
    p = tmp_path / "rw.toml"
    p.write_text(text)
    errs = []
    for mod in (RC, PC):
        with pytest.raises(ValueError, match=match) as ei:
            mod.NodeConfig.from_toml(str(p))
        errs.append(str(ei.value))
    assert errs[0] == errs[1]


def test_device_section_typo_fails_even_when_off(tmp_path):
    p = tmp_path / "rw.toml"
    p.write_text("[device]\nmode = 'off'\ncapcity = 9\n")
    with pytest.raises(ValueError, match="unknown config key"):
        PC.NodeConfig.from_toml(str(p))


@pytest.mark.parametrize("name,value", [
    ("pause_on_next_bootstrap", "true"), ("pause_on_next_bootstrap", "off"),
    ("pause_on_next_bootstrap", 1), ("checkpoint_frequency", "7"),
    ("checkpoint_frequency", 3.0), ("barrier_interval_ms", "250"),
    ("checkpoint_frequency", 0), ("barrier_interval_ms", -1),
    ("bogus", 1)])
def test_system_params_coercion(name, value):
    outs = []
    for mod in (RC, PC):
        sp = mod.SystemParams()
        try:
            outs.append(("ok", sp.set(name, value), dict(sp.values)))
        except ValueError as e:
            outs.append(("err", str(e), dict(sp.values)))
    assert outs[0] == outs[1]
    sp = PC.SystemParams()
    with pytest.raises(ValueError):
        sp.get("bogus")
    with pytest.raises(ValueError, match=">= 1"):
        sp.set("checkpoint_frequency", 0)


@pytest.mark.parametrize("cls", ["DeviceConfig", "StreamingConfig",
                                 "StorageConfig", "RobustnessConfig",
                                 "NodeConfig"])
def test_dataclass_fields_and_defaults(cls):
    ref, got = getattr(RC, cls)(), getattr(PC, cls)()
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(ref)]
    assert fields_of(got) == fields_of(ref)


@pytest.mark.parametrize("env", [
    {},
    {"RW_OVERLOAD_STRETCH": "2", "RW_LOAD_SHED": "true",
     "RW_OVERLOAD_HOLD_S": "0.5", "RW_SELECT_CONCURRENCY": "0"},
    {"RW_SERVING_CACHE": "off", "RW_POISON_PILL": "x",
     "RW_HEARTBEAT_TIMEOUT_S": "1", "RW_FUSED_EPOCH_LOG_BYTES": "4096"},
    {"RW_INCREMENTAL_REFRESH": "no", "RW_OVERLOAD_LADDER": "0"},
])
def test_robustness_reads_the_same_environment(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ref, got = RC.RobustnessConfig.from_env(), PC.RobustnessConfig.from_env()
    assert fields_of(got) == fields_of(ref)
    assert isinstance(PC.ROBUSTNESS, PC.RobustnessConfig)


@pytest.mark.parametrize("var,raw", [("RW_LOAD_SHED", "maybe"),
                                     ("RW_OVERLOAD_STRETCH", "2.5"),
                                     ("RW_OVERLOAD_HIGH", "high")])
def test_robustness_bad_environment_fails_alike(monkeypatch, var, raw):
    monkeypatch.setenv(var, raw)
    errs = []
    for mod in (RC, PC):
        with pytest.raises(ValueError) as ei:
            mod.RobustnessConfig.from_env()
        errs.append(str(ei.value))
    assert errs[0] == errs[1] and var in errs[1]


def test_session_vars():
    assert PC.SESSION_VAR_DEFAULTS == RC.SESSION_VAR_DEFAULTS
    a = PC.default_session_vars()
    a["timezone"] = "X"
    assert PC.default_session_vars() == RC.default_session_vars()


@pytest.mark.parametrize("arg", [None, "off", "on", "single", "bad",
                                 "config"])
def test_resolve_device(arg):
    """`config.resolve_device` normalizes the Database argument the same
    way; it is not the package root's nor `device.resolve_device`."""
    outs = []
    for mod in (RC, PC):
        a = mod.DeviceConfig(capacity=77) if arg == "config" else arg
        try:
            cfg = mod.resolve_device(a)
            outs.append(("ok", fields_of(cfg)))
            if arg == "config":
                assert cfg is a
        except ValueError as e:
            outs.append(("err", str(e)))
    assert outs[0] == outs[1]
    import risingwave_tpu_torch as pkg
    import risingwave_tpu_torch.device as pdev
    assert not hasattr(pkg, "resolve_device")
    assert pdev.resolve_device is not PC.resolve_device


def test_resolve_device_mesh_without_gpu():
    """An int lays that many shards on `cuda:0` (`make_mesh`): with no
    GPU, it raises rather than falling back to the CPU."""
    if torch.cuda.is_available():
        cfg = PC.resolve_device(3)
        assert cfg.mesh.n == 3
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PC.resolve_device(3)
