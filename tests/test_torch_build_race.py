"""Concurrent first builds of the kernel libraries.

Two TaskExecutors of one process (the cluster's in-process layout) can make
their first K1 dispatch at once in a cold build directory. Both then call
`ops/cuda_superscan.py::build`: it must build each library once, leave no
temporary file behind and raise in neither thread. A stand-in compiler
(a script that writes its `-o` file after a short sleep) takes nvcc's
place, so the race shows without a CUDA toolkit.
"""

import os
import stat
import threading

from flink_tpu_torch.ops import cuda_superscan as cs


def _fake_nvcc(tmp_path, calls):
    script = tmp_path / "nvcc"
    script.write_text(
        "#!/bin/sh\n"
        f"echo $$ >> {calls}\n"
        "out=''\n"
        "while [ $# -gt 0 ]; do if [ \"$1\" = -o ]; then out=$2; fi; shift; done\n"
        "sleep 0.3\n"
        "printf 'lib' > \"$out\"\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return str(script)


def test_two_threads_build_one_library_and_leave_no_temp_files(tmp_path, monkeypatch):
    calls = tmp_path / "calls"
    monkeypatch.setattr(cs, "_nvcc", lambda: _fake_nvcc(tmp_path, calls))
    monkeypatch.setattr(cs, "BUILD_DIR", tmp_path / "build")
    results, errors = [], []
    barrier = threading.Barrier(2)

    def first_dispatch():
        barrier.wait()
        try:
            results.append(cs.build(["superscan"]))
        except Exception as e:  # noqa: BLE001 - the test reports it
            errors.append(e)

    threads = [threading.Thread(target=first_dispatch) for _ in range(2)]
    [t.start() for t in threads]
    [t.join(30) for t in threads]
    assert not errors, errors
    assert len(results) == 2 and results[0] == results[1]
    built = results[0]["superscan"]
    assert built.read_text() == "lib"
    # one compiler run: the second thread found the library built
    assert len(calls.read_text().split()) == 1
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == sorted(
        [built.name, built.with_suffix(".log").name])


def test_a_build_in_a_warm_directory_runs_no_compiler(tmp_path, monkeypatch):
    calls = tmp_path / "calls"
    monkeypatch.setattr(cs, "_nvcc", lambda: _fake_nvcc(tmp_path, calls))
    monkeypatch.setattr(cs, "BUILD_DIR", tmp_path / "build")
    first = cs.build(["superscan", "global_superscan"])
    assert len(calls.read_text().split()) == 2
    assert cs.build(["superscan", "global_superscan"]) == first
    assert len(calls.read_text().split()) == 2
    assert not [p for p in (tmp_path / "build").iterdir() if p.name.startswith("tmp-")]
    assert os.path.exists(first["global_superscan"])
