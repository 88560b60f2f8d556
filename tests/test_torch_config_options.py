"""Every option key of the JAX package's configuration, held against the
port's (fault C4).

The JAX `Configuration` defines options on its option classes; a job
configured for the JAX package must configure the port the same way. For
every key of every JAX option class the port either accepts it and reads
back the JAX default, or raises `NotImplementedError` naming a ROADMAP.md
Queue A item (never the catch-all label of a key that no item carries).
The cluster's option groups and the layered surface (load, from_env,
add_all, fallback keys) read as the JAX package's.
The nine options that no module of either package reads are accepted
with the JAX defaults, on the option classes JAX keeps them on, and
bench.py::api_path_microbench's program run with two of them set gives
the JAX package's rows. Keys the JAX package does not define keep raising.
"""

import inspect

import pytest

jnp = pytest.importorskip("jax.numpy")

import flink_tpu.config as jcfg  # noqa: E402
import flink_tpu_torch.config as tcfg  # noqa: E402
from jax_native_twins import jax_native_library  # noqa: E402,F401

QUEUE_A = "not ported yet: ROADMAP.md Queue A, item "


def _jax_options():
    return sorted(((name, attr, opt) for name, cls in inspect.getmembers(jcfg, inspect.isclass)
                   for attr, opt in vars(cls).items() if isinstance(opt, jcfg.ConfigOption)),
                  key=lambda t: t[2].key)


def _port_option(key):
    for cls in vars(tcfg).values():
        if inspect.isclass(cls):
            for opt in vars(cls).values():
                if isinstance(opt, tcfg.ConfigOption) and opt.key == key:
                    return cls.__name__, opt
    return None, None


@pytest.mark.parametrize("cls,attr,opt", _jax_options(), ids=lambda v: getattr(v, "key", None))
def test_every_jax_option_is_accepted_with_its_default_or_names_a_queue_a_item(cls, attr, opt):
    value = opt.default if opt.default is not None else "x"
    try:
        conf = tcfg.Configuration({opt.key: value})
    except NotImplementedError as e:
        assert QUEUE_A in str(e), str(e)
        assert _port_option(opt.key) == (None, None)
        return
    port_cls, port_opt = _port_option(opt.key)
    assert port_cls == cls and getattr(getattr(tcfg, cls), attr) is port_opt
    assert port_opt.default == opt.default and port_opt.type == opt.type
    assert conf.get(port_opt) == jcfg.Configuration({opt.key: value}).get(opt)
    assert tcfg.Configuration().get(port_opt) == opt.default


UNREAD = {"pipeline.auto-watermark-interval": ("PipelineOptions", 200),
          "pipeline.object-reuse": ("PipelineOptions", True),
          "execution.step.batch-timeout-ms": ("ExecutionOptions", 10),
          "execution.runtime-mode": ("ExecutionOptions", "STREAMING"),
          "device.mesh.axis-name": ("DeviceOptions", "shards"),
          "device.mesh.num-shards": ("DeviceOptions", 0),
          "device.donate-state": ("DeviceOptions", True),
          "metrics.latency.interval": ("MetricOptions", 0),
          "metrics.reporters": ("MetricOptions", [])}


@pytest.mark.parametrize("key", sorted(UNREAD))
def test_options_no_module_reads_are_defined_with_the_jax_defaults(key):
    cls, default = UNREAD[key]
    assert _port_option(key) == (cls, _port_option(key)[1])
    assert _port_option(key)[1].default == default
    assert tcfg.Configuration({key: default}).get(_port_option(key)[1]) == default


CLUSTER_KEYS = {"exchange.wire-format": "pickle", "exchange.credit-batch": 4,
                "exchange.debloat.enabled": False,
                "execution.watchdog.stuck-task-timeout-ms": 3000,
                "observability.shipping.interval-ms": 50,
                "security.transport.cluster-id": "c1",
                "security.ssl.internal.enabled": True}


@pytest.mark.parametrize("key", sorted(CLUSTER_KEYS))
def test_cluster_options_name_the_cluster_item(key):
    """The cluster's option groups (security.*, exchange.*,
    execution.watchdog.*, observability.shipping.*) are the port's now: a
    set value reads back as the JAX package reads it, on the class the JAX
    package keeps the option on."""
    cls, opt = _port_option(key)
    jax_opt = next(o for _n, _a, o in _jax_options() if o.key == key)
    assert cls is not None and opt.default == jax_opt.default
    value = CLUSTER_KEYS[key]
    assert (tcfg.Configuration({key: value}).get(opt)
            == jcfg.Configuration({key: value}).get(jax_opt) == value)


@pytest.mark.parametrize("key,fallback,value", [
    ("security.transport.secret-file", "security.transport.secret.file", "/x/s"),
    ("security.transport.cluster-id", "security.transport.cluster.id", "c2")])
def test_fallback_keys_resolve_as_in_jax(key, fallback, value):
    _cls, opt = _port_option(key)
    jax_opt = next(o for _n, _a, o in _jax_options() if o.key == key)
    assert opt.fallback_keys == jax_opt.fallback_keys == (fallback,)
    port, jax = tcfg.Configuration({fallback: value}), jcfg.Configuration({fallback: value})
    assert port.get(opt) == jax.get(jax_opt) == value
    assert port.contains(opt) and jax.contains(jax_opt)


def test_layered_surface_matches_jax(tmp_path, monkeypatch):
    """load < from_env < add_all, with get_string, key_set, to_dict,
    contains, remove and clone, in both packages."""
    yaml = tmp_path / "conf.yaml"
    yaml.write_text("# c\nexchange.credit-batch: 8\nsecurity.transport.cluster-id: a\n")
    js = tmp_path / "conf.json"
    js.write_text('{"exchange.debloat.enabled": false, "pipeline.name": "j"}')
    monkeypatch.setenv("FLINK_TPU_SECURITY_TRANSPORT_CLUSTER_ID", "from-env")
    out = {}
    for name, mod in (("port", tcfg), ("jax", jcfg)):
        conf = mod.Configuration.load(str(yaml)).add_all(mod.Configuration.from_env())
        conf.add_all(mod.Configuration.load(str(js)))
        other = conf.clone()
        removed = other.remove(mod.ExchangeOptions.CREDIT_BATCH)
        out[name] = (conf.to_dict(), sorted(conf.key_set()),
                     conf.get_string("exchange.credit-batch"),
                     conf.get(mod.ExchangeOptions.CREDIT_BATCH),
                     conf.get(mod.SecurityOptions.TRANSPORT_CLUSTER_ID),
                     conf.get(mod.ExchangeOptions.DEBLOAT_ENABLED),
                     conf.contains(mod.ExchangeOptions.CREDIT_BATCH),
                     removed, other.contains(mod.ExchangeOptions.CREDIT_BATCH),
                     conf == mod.Configuration(conf.to_dict()),
                     conf.get(mod.WatchdogOptions.STUCK_TASK_TIMEOUT_MS, 7))
    assert out["port"] == out["jax"]
    # the file's primary key outranks the env's fallback spelling, in both
    assert out["port"][4] == "a" and out["port"][3] == 8


def test_list_option_reads_a_semicolon_string_as_jax_does():
    for value in ("jmx; prom", ["a"]):
        assert (tcfg.Configuration({"metrics.reporters": value}).get(tcfg.MetricOptions.REPORTERS)
                == jcfg.Configuration({"metrics.reporters": value}).get(
                    jcfg.MetricOptions.REPORTERS))


@pytest.mark.parametrize("mode", ["fused", "chain", "scalar"])
def test_api_path_program_with_unread_options_gives_the_jax_rows(mode):
    """api_path_microbench's program at 4096 records with
    pipeline.object-reuse and execution.runtime-mode set: the JAX package
    runs it, and so does the port, to the same rows."""
    import test_torch_datastream as tds_twins

    unread = {"pipeline.object-reuse": False, "execution.runtime-mode": "STREAMING"}
    rows = {}
    for name, pkg in (("port", tds_twins.PORT), ("jax", tds_twins.JAX)):
        env_kw = {"device": "cpu"} if name == "port" else {}
        pkg = dict(pkg, cfg=lambda pkg=pkg: pkg["cfg"](dict(unread)))
        env, sink = tds_twins._build(pkg, mode, tds_twins.SLIDING, "count", False, n=4096,
                                     **env_kw)
        assert env.config.get(pkg["opts"].BATCH_SIZE) == tds_twins.BATCH
        env.execute()
        rows[name] = sorted((int(k), float(v)) for k, v in sink.results)
    assert rows["port"] and rows["port"] == rows["jax"]
