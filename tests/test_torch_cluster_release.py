"""An ended or superseded task of the port's cluster lets go of its
runtime, so a restarted attempt's device rings are not alive beside the
dead attempt's.

A TaskExecutor keeps its ended tasks (their last metrics ship on the
heartbeat) and a stage's input source, kept by the job's graph, reaches the
stage's runtime through the barrier aligner's callback. Here the window
stage of a two-stage job runs on a TaskExecutor that is then stopped; at
the restarted attempt's first sink batch only the new attempt's fused
pipeline may be alive (weak references, no collection forced). On the card
`chip_smoke.py` phase 32 leg B holds the same as device memory.
"""

import gc
import tempfile
import weakref

from flink_tpu_torch.config import ExecutionOptions
from flink_tpu_torch.runtime import fused_window_pipeline as fwp
from flink_tpu_torch.testing import cluster_jobs as cj
from flink_tpu_torch.testing.harness import ephemeral_transport_security

import chip_smoke as smoke


def test_a_stopped_task_executors_stage_is_released_before_the_restart_emits(monkeypatch):
    pipes = []
    real = fwp.FusedWindowPipeline.__init__

    def init(self, *a, **kw):
        real(self, *a, **kw)
        pipes.append(weakref.ref(self))

    monkeypatch.setattr(fwp.FusedWindowPipeline, "__init__", init)
    n, label = 1 << 17, "release-test"
    spec = cj.api_graph_spec("release", n, stages=True, label=label, keys=64, batch=4096,
                             window_ms=10_000, slide_ms=1_000, device="cpu",
                             gen=cj.ApiGen(n, 64, delay_s=0.05))
    spec.config.set(ExecutionOptions.SUPERBATCH_STEPS, 4)
    firsts = cj.FIRST_WRITE_BYTES.setdefault(label, [])
    alive = []
    real_write = cj._TimedWriter.write_batch

    def write_batch(self, values, timestamps=None):
        if self.label is not None:        # an attempt's first sink batch
            alive.append(sum(r() is not None for r in pipes))
        real_write(self, values, timestamps)

    monkeypatch.setattr(cj._TimedWriter, "write_batch", write_batch)
    with smoke._Cluster(ephemeral_transport_security(), "cpu",
                        checkpoint_dir=tempfile.mkdtemp(prefix="release-"),
                        checkpoint_interval=0.2, restart_attempts=3, restart_delay=0.2,
                        heartbeat_timeout=5.0, adaptive=False) as c:
        job = c.client.submit_job(spec.to_bytes(), 1)
        c.until(lambda: c.client.job_status(job)["checkpoints"] and firsts, 60,
                "a checkpoint and the first rows")
        window_te = next(i for i, te in enumerate(c.tes)
                         if any(shard == 1 for (_j, _a, shard) in te._tasks))
        te = c.tes[window_te]
        te.stop()
        c.svcs[window_te + 1].stop()
        for task in list(te._tasks.values()):
            task.thread.join(60)
        gc.collect()                      # what the stopped process's exit frees
        c.add_tm()
        status = c.wait(job, timeout=120)
    assert status["status"] == "FINISHED" and status["restarts"] >= 1, status
    assert len(alive) >= 2 and alive[0] == 1
    assert alive[-1] == 1, alive          # the dead attempt's pipeline is gone
