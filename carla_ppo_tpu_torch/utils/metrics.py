"""Metrics / logging: TensorBoard scalars, text summaries, episodic means
(the port's own copy of carla_ppo_tpu/utils/metrics.py).

TensorBoard is the reference's one observability system (SURVEY.md section 5;
reference: ppo.py:149-181, train.py:124-129 + 210-215). Parity pieces:

- scalar metric streams under the same names ("train_loss/policy",
  "train/reward", "eval/distance_traveled", ...);
- hyperparameters dumped as a text summary at step 0
  (reference: ppo.py:267-269, train.py:114);
- `MeanMetrics` mirrors tf.metrics.mean accumulate-then-flush semantics for
  host-side loops (the fused train path aggregates on device instead).

Writer backend: tensorboardX if importable, else a no-op stub (so headless
training never hard-depends on it).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Mapping, Optional


class MetricsWriter:
    """Thin TensorBoard scalar writer (no-op without tensorboardX, or when
    not `enabled`: a data-parallel rank other than 0)."""

    def __init__(self, log_dir: str, enabled: bool = True):
        self.log_dir = log_dir
        self._writer = None
        if not enabled:
            return
        try:
            from tensorboardX import SummaryWriter

            self._writer = SummaryWriter(log_dir)
        except Exception:
            self._writer = None

    def write_scalar(self, name: str, value: float, step: int) -> None:
        if self._writer is not None:
            self._writer.add_scalar(name, float(value), int(step))

    def write_scalars(self, metrics: Mapping[str, float], step: int) -> None:
        for name, value in metrics.items():
            self.write_scalar(name, value, step)

    def write_text(self, name: str, text: str, step: int = 0) -> None:
        if self._writer is not None:
            self._writer.add_text(name, text, int(step))

    def write_hparams(self, params: Mapping, step: int = 0) -> None:
        """Hyperparameters as a markdown table (reference: ppo.py:267-269)."""
        lines = ["| key | value |", "| --- | --- |"] + [
            f"| {k} | {v} |" for k, v in params.items()
        ]
        self.write_text("hyperparameters", "\n".join(lines), step)

    def flush(self) -> None:
        if self._writer is not None:
            self._writer.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()


class MeanMetrics:
    """Accumulate means, flush per episode (reference: utils.py:36-43 +
    ppo.py:271-273 reset via local_variables_initializer)."""

    def __init__(self) -> None:
        self._sums: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)

    def add(self, metrics: Mapping[str, float]) -> None:
        for k, v in metrics.items():
            self._sums[k] += float(v)
            self._counts[k] += 1

    def means(self) -> Dict[str, float]:
        return {k: self._sums[k] / self._counts[k] for k in self._sums}

    def flush(self, writer: Optional[MetricsWriter], step: int) -> Dict[str, float]:
        out = self.means()
        if writer is not None:
            writer.write_scalars(out, step)
        self._sums.clear()
        self._counts.clear()
        return out
