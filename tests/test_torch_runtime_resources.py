"""The port's managed memory and external resource drivers
(`runtime/memory.py`, `runtime/external_resources.py`) against the JAX
package's, with `torch.cuda` mocked on the CPU: the budget comes from
`torch.cuda.mem_get_info`, the "cuda" driver reports the devices torch
sees."""

import types

import pytest
import torch

pytest.importorskip("jax")

from flink_tpu.runtime import external_resources as jer
from flink_tpu.runtime import memory as jmem
from flink_tpu_torch.runtime import external_resources as ter
from flink_tpu_torch.runtime import memory as tmem


def _fake_card(monkeypatch, total=80 << 30, count=2):
    props = types.SimpleNamespace(name="NVIDIA H100 80GB HBM3", major=9, minor=0,
                                  total_memory=total, multi_processor_count=132)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (total // 2, total))
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda i: props)


@pytest.mark.parametrize("headroom", [0.1, 0.25])
def test_budget_is_the_cards_memory_less_headroom(monkeypatch, headroom):
    _fake_card(monkeypatch)
    assert tmem.MemoryManager.for_device(headroom=headroom).budget == int(
        (80 << 30) * (1 - headroom))
    assert tmem.MemoryManager.for_device("cuda:0", headroom=headroom).budget == int(
        (80 << 30) * (1 - headroom))


def test_budget_without_a_card_is_the_jax_packages_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    want = jmem.MemoryManager.for_device().budget          # JAX on the CPU: no memory stats
    assert tmem.MemoryManager.for_device().budget == want == int((8 << 30) * 0.9)
    _fake_card(monkeypatch)
    assert tmem.MemoryManager.for_device("cpu").budget == want

    def broken(device=None):
        raise RuntimeError("CUDA driver error")
    monkeypatch.setattr(torch.cuda, "mem_get_info", broken)
    assert tmem.MemoryManager.for_device().budget == want


def test_reservations_match_jax():
    def story(m):
        seen = []
        for owner, n in (("ring", 300), ("spill", 200), ("ring", 100)):
            m.reserve(owner, n)
            seen.append((m.available(), m.used_by(owner)))
        with pytest.raises(MemoryError) as err:
            m.reserve("exchange", 500)
        seen.append(type(err.value).__name__)
        m.release("ring", 150)
        m.release("missing")
        seen.append((m.available(), m.used_by("ring")))
        m.release("spill")
        seen.append((m.available(), m.split_by_weights({"a": 1, "b": 3})))
        return seen
    assert story(tmem.MemoryManager(1000)) == story(jmem.MemoryManager(1000))


def test_cuda_driver_reports_the_devices_torch_sees(monkeypatch):
    _fake_card(monkeypatch, count=2)
    infos = ter.get_external_resource_infos("cuda")
    assert [i.get_property("id") for i in infos] == [0, 1]
    assert infos[0].properties == {
        "id": 0, "platform": "gpu", "device_kind": "NVIDIA H100 80GB HBM3",
        "compute_capability": "9.0", "memory_bytes": 80 << 30,
        "multiprocessor_count": 132, "process_index": 0}
    assert len(ter.get_external_resource_infos("cuda", amount=1)) == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ter.get_external_resource_infos("cuda") == []


@pytest.mark.parametrize("visible", ["", "0", "2,3", "0, 1,,5"])
def test_gpu_driver_matches_jax(monkeypatch, visible):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    for amount in (0, 1):
        got = [i.properties for i in ter.get_external_resource_infos("gpu", amount)]
        assert got == [i.properties for i in jer.get_external_resource_infos("gpu", amount)]


def test_unknown_driver_and_registration():
    with pytest.raises(KeyError, match="no external resource driver"):
        ter.get_external_resource_infos("fpga")

    class Fpga(ter.ExternalResourceDriver):
        name = "fpga-test"

        def retrieve_resource_info(self, amount):
            return [ter.ExternalResourceInfo({"slot": amount})]

    ter.register_driver(Fpga())
    info = ter.get_external_resource_infos("fpga-test", 3)[0]
    assert info.get_property("slot") == 3 and "slot" in repr(info)
    with pytest.raises(NotImplementedError):
        ter.ExternalResourceDriver().retrieve_resource_info(1)
