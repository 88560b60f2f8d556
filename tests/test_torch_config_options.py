"""Every option key of the JAX package's configuration, held against the
port's (fault C4).

The JAX `Configuration` defines options on its option classes; a job
configured for the JAX package must configure the port the same way. For
every key of every JAX option class the port either accepts it and reads
back the JAX default, or raises `NotImplementedError` naming a ROADMAP.md
Queue A item (never the catch-all label of a key that no item carries).
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


@pytest.mark.parametrize("key", ["exchange.wire-format", "exchange.credit-batch",
                                 "exchange.debloat.enabled",
                                 "execution.watchdog.stuck-task-timeout-ms"])
def test_cluster_options_name_the_cluster_item(key):
    with pytest.raises(NotImplementedError, match="item 14 \\(remaining planes: the cluster"):
        tcfg.Configuration({key: 1})


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
