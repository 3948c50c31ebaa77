"""Stall watchdog for unattended training runs (the port's own copy of
carla_ppo_tpu/utils/watchdog.py).

A process wedged inside a device call cannot be interrupted from Python, so
the recovery unit is the PROCESS: a daemon thread watches a heartbeat the
training loop touches once per iteration and calls os._exit(STALL_EXIT_CODE)
when it goes quiet, letting a wrapper relaunch the same command - autosave
checkpoints every N iterations plus auto-resume make that cheap
(scripts/train_unattended.sh is the wrapper of the JAX package's CLI).
"""

from __future__ import annotations

import os
import sys
import threading
import time

# Exit code a relaunch wrapper should treat as "stalled, run me again".
STALL_EXIT_CODE = 17


class StallWatchdog:
    """Daemon thread that force-exits the process when the heartbeat stalls.

    `timeout_s` must comfortably exceed the slowest legitimate gap between
    heartbeats: an eval of `eval_max_steps` steps is one such gap, and the
    first iteration also builds the CUDA kernels.
    """

    def __init__(
        self,
        timeout_s: float,
        check_interval_s: float = 15.0,
        _exit_fn=os._exit,  # injectable for tests; production always _exits
    ):
        self.timeout_s = float(timeout_s)
        self._check_interval_s = float(check_interval_s)
        self._exit_fn = _exit_fn
        self._last_beat = time.monotonic()
        self._stopped = False
        self._thread = threading.Thread(
            target=self._run, name="stall-watchdog", daemon=True
        )
        self._thread.start()

    def beat(self) -> None:
        """Mark progress; call at least once per `timeout_s`."""
        self._last_beat = time.monotonic()

    def stop(self) -> None:
        """Disarm (normal shutdown path)."""
        self._stopped = True

    def _run(self) -> None:
        while not self._stopped:
            time.sleep(self._check_interval_s)
            quiet = time.monotonic() - self._last_beat
            if not self._stopped and quiet > self.timeout_s:
                print(
                    f"stall-watchdog: no training progress for {quiet:.0f} s "
                    f"(> {self.timeout_s:.0f} s); exiting with code "
                    f"{STALL_EXIT_CODE} for relaunch (resume picks up from the "
                    "last autosave)",
                    file=sys.stderr,
                    flush=True,
                )
                # sys.exit only raises in this thread; the wedged main thread
                # is stuck in native code and would never see it. _exit is
                # the point.
                self._exit_fn(STALL_EXIT_CODE)
