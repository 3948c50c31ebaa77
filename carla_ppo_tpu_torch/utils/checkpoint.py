"""Step-keyed checkpoints of whole train states (port of
carla_ppo_tpu/utils/checkpoint.py, torch files in place of orbax).

Each step is an integer-named directory under the checkpoint dir holding
one `state.pt`, written to a temporary directory first and renamed into
place, so a reader never sees half a checkpoint. The newest `max_to_keep`
steps are kept. Files are read with `torch.load(weights_only=True)`: a
checkpoint holds tensors, numbers, strings and dicts, nothing pickled.

What is saved is a tree (nested dicts of tensors and numbers). `save`
accepts any object with a `checkpoint_tree()` method (training.ppo's
TrainState) or a tree; `restore` rebuilds onto the template: an object with
`restored(tree)` builds its own copy, a tree template gets the file's
values on each template tensor's device and dtype. Counters live inside the
saved state, so a resume continues the numbering.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, List, Optional

import torch

STATE_FILE = "state.pt"


class Checkpointer:
    def __init__(self, checkpoint_dir: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(checkpoint_dir)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep

    def all_steps(self) -> List[int]:
        return sorted(
            int(e) for e in os.listdir(self.directory)
            if e.isdigit() and os.path.isfile(os.path.join(self.directory, e, STATE_FILE))
        )

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Any) -> None:
        if hasattr(tree, "checkpoint_tree"):  # a TrainState
            tree = tree.checkpoint_tree()
        tmp = tempfile.mkdtemp(prefix=f".tmp-{int(step)}-", dir=self.directory)
        try:
            torch.save(tree, os.path.join(tmp, STATE_FILE))
            final = os.path.join(self.directory, str(int(step)))
            if os.path.isdir(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
        finally:
            if os.path.isdir(tmp):
                shutil.rmtree(tmp)
        for old in self.all_steps()[: -self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def read_tree(self, step: int) -> dict:
        """The saved tree of `step`, on the CPU."""
        path = os.path.join(self.directory, str(int(step)), STATE_FILE)
        return torch.load(path, map_location="cpu", weights_only=True)

    def restore(self, step: int, template: Any) -> Any:
        tree = self.read_tree(step)
        if hasattr(template, "restored"):
            return template.restored(tree)
        return onto_template(template, tree)

    def restore_latest(self, template: Any) -> Optional[Any]:
        """The newest checkpoint rebuilt onto `template`, or None."""
        step = self.latest_step()
        return None if step is None else self.restore(step, template)

    def close(self) -> None:
        """Nothing to release (saves are synchronous); kept for the JAX
        Checkpointer's interface."""


def onto_template(template: Any, tree: Any) -> Any:
    """`tree`'s values in `template`'s structure: each tensor on its
    template tensor's device and dtype, after a shape check."""
    if isinstance(template, dict):
        missing = set(template) - set(tree)
        if missing:
            raise KeyError(f"checkpoint lacks {sorted(missing)}")
        return {k: onto_template(v, tree[k]) for k, v in template.items()}
    if isinstance(template, torch.Tensor):
        if tuple(tree.shape) != tuple(template.shape):
            raise ValueError(f"checkpoint shape {tuple(tree.shape)} != {tuple(template.shape)}")
        return tree.to(device=template.device, dtype=template.dtype)
    return tree
