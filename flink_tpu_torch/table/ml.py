"""Model inference in SQL / streams: the `flink-models` analogue.

Counterpart of `flink_tpu/table/ml.py`. The reference exposes SQL
`ML_PREDICT` against model endpoints through a provider SPI
(flink-table-common/.../ml/PredictRuntimeProvider.java:26; runtime operator
flink-table-runtime/.../ml/MLPredictRunner.java).

The port's natural provider is a torch model running on the same card as
the pipeline: features come out of the stream as columns, inference is one
batched call under `torch.inference_mode()`, outputs rejoin the row.
`PredictRuntimeProvider`, `FnModelProvider` and `BatchingPredictor` are the
JAX package's, copied; `TorchModelProvider` takes the place of its
`JaxModelProvider`, with the same power-of-two padding, and
`params_from_numpy` carries a JAX provider's numpy weights over.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from flink_tpu_torch.utils.device import resolve_device


class PredictRuntimeProvider:
    """SPI: batched model inference over feature columns.

    **Determinism contract (changelog inputs).** ML_PREDICT over a retract
    stream re-scores each row twice: once for the +I and once for the -D
    that retracts it. The runtime matches a retraction to the row it
    retracts BY VALUE (StreamingJoinRunner / group-agg multisets), so
    `predict_batch` MUST be a pure function of its features — the -D's
    re-scored row must reproduce the +I's scored row bit-for-bit, or the
    retraction will not cancel its insert downstream (phantom rows in
    joins/aggregates). Providers with dropout left on, sampling
    temperature, non-deterministic kernels, or remote models that drift
    between calls violate this; freeze the model (eval mode, fixed
    weights, greedy decoding) or materialize scores before the changelog
    fans into stateful operators."""

    feature_cols: List[str]
    output_names: List[str]

    def predict_batch(self, features: np.ndarray) -> np.ndarray:
        """[B, n_features] -> [B, n_outputs]."""
        raise NotImplementedError

    def predict_row(self, row: dict) -> Dict[str, float]:
        feats = np.asarray([[float(row[c]) for c in self.feature_cols]], dtype=np.float32)
        out = np.asarray(self.predict_batch(feats))
        return {name: out[0, i].item() for i, name in enumerate(self.output_names)}


def params_from_numpy(params, device=None):
    """The nested dict / list / tuple of numpy arrays a JAX provider holds,
    as the same structure of tensors on `device` (resolved as every entry
    point resolves it: CUDA unless the caller asks for the CPU)."""
    dev = resolve_device(device)

    def carry(p):
        if isinstance(p, dict):
            return {k: carry(v) for k, v in p.items()}
        if isinstance(p, (list, tuple)):
            return type(p)(carry(v) for v in p)
        return torch.from_numpy(np.array(p, copy=True)).to(dev)

    return carry(params)


class TorchModelProvider(PredictRuntimeProvider):
    """A torch model as the inference runtime.

    `apply(params, features[B, F]) -> [B, O]` on tensors of the provider's
    device, run under `torch.inference_mode()`. Batches are padded to powers
    of two (at least `min_pad` rows) so the card sees a handful of shapes,
    as the JAX provider's jit compiles a handful (the MLPredictRunner role,
    on-device)."""

    def __init__(
        self,
        apply: Callable,
        params,
        feature_cols: Sequence[str],
        output_names: Sequence[str],
        *,
        device=None,
        min_pad: int = 16,
    ):
        self.device = resolve_device(device)
        self.feature_cols = list(feature_cols)
        self.output_names = list(output_names)
        self.params = params
        self.min_pad = min_pad
        self._fn = apply

    def predict_batch(self, features: np.ndarray) -> np.ndarray:
        n = len(features)
        padded = self.min_pad
        while padded < n:
            padded *= 2
        if padded != n:
            features = np.concatenate(
                [features, np.zeros((padded - n, features.shape[1]), features.dtype)]
            )
        x = torch.from_numpy(np.ascontiguousarray(features)).to(self.device)
        with torch.inference_mode():
            out = self._fn(self.params, x)
        return out.cpu().numpy()[:n]


class FnModelProvider(PredictRuntimeProvider):
    """Plain-python/numpy provider (external-endpoint stand-in)."""

    def __init__(self, fn: Callable[[np.ndarray], np.ndarray],
                 feature_cols: Sequence[str], output_names: Sequence[str]):
        self.fn = fn
        self.feature_cols = list(feature_cols)
        self.output_names = list(output_names)

    def predict_batch(self, features: np.ndarray) -> np.ndarray:
        return np.asarray(self.fn(features))


class BatchingPredictor:
    """Per-stream adapter: buffers rows to amortize device dispatches while
    preserving 1:1 row order (the micro-batching the device wants; flushed
    by the runner at watermark/step boundaries)."""

    def __init__(self, provider: PredictRuntimeProvider, max_batch: int = 1024):
        self.provider = provider
        self.max_batch = max_batch
        self._rows: List[dict] = []
        self._out: List[dict] = []

    def offer(self, row: dict) -> None:
        self._rows.append(row)
        if len(self._rows) >= self.max_batch:
            self.flush()

    def flush(self) -> None:
        if not self._rows:
            return
        rows, self._rows = self._rows, []
        feats = np.asarray(
            [[float(r[c]) for c in self.provider.feature_cols] for r in rows],
            dtype=np.float32,
        )
        preds = np.asarray(self.provider.predict_batch(feats))
        for i, r in enumerate(rows):
            out = dict(r)
            for j, name in enumerate(self.provider.output_names):
                out[name] = preds[i, j].item()
            self._out.append(out)

    def drain(self) -> List[dict]:
        self.flush()
        out, self._out = self._out, []
        return out
