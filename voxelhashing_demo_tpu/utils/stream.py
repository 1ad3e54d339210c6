"""Streaming frame pipeline: background decode + device-transfer prefetch.

The reference loads its two frames synchronously in the constructor
(Application.cpp:28-29).  At sequence scale, decode and host->device
transfer must overlap device compute or they serialize into the frame time.
This pipeline runs a producer thread that (a) decodes depth PNGs in batches
through the native multi-threaded codec (utils/io.py) and (b) stages each
frame onto the device with ``jax.device_put`` ahead of consumption, keeping
a bounded queue of device-resident frames ready for the SLAM step.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Optional, Sequence

import jax
import numpy as np

from . import io as depth_io

_SENTINEL = object()


class FramePipeline:
    """Iterate device-ready depth frames from a list of PNG paths.

    Usage::

        pipe = FramePipeline(paths, width=640, height=480, prefetch=4)
        for depth in pipe:          # jnp uint16 (H, W), already on device
            slam.process(depth)
    """

    def __init__(
        self,
        paths: Sequence[str],
        width: int,
        height: int,
        prefetch: int = 4,
        decode_batch: int = 8,
        device=None,
    ):
        self.paths = list(paths)
        self.width = width
        self.height = height
        self.decode_batch = max(1, decode_batch)
        self.device = device or jax.devices()[0]
        self._q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _produce(self) -> None:
        try:
            for start in range(0, len(self.paths), self.decode_batch):
                if self._stop.is_set():
                    return
                chunk = self.paths[start : start + self.decode_batch]
                batch = depth_io.read_depth_batch(
                    chunk, self.width, self.height
                )
                for img in batch:
                    # stage onto the device while the consumer computes;
                    # poll the stop flag so an abandoned consumer doesn't
                    # leave this thread blocked on a full queue forever
                    staged = jax.device_put(img, self.device)
                    while not self._stop.is_set():
                        try:
                            self._q.put(staged, timeout=0.2)
                            break
                        except queue.Full:
                            continue
                    if self._stop.is_set():
                        return
        except BaseException as e:  # surface in the consumer thread
            self._err = e
        finally:
            # deliver the sentinel unless the pipeline was closed (a
            # dropped sentinel would hang a live consumer forever)
            while not self._stop.is_set():
                try:
                    self._q.put(_SENTINEL, timeout=0.2)
                    break
                except queue.Full:
                    continue

    def close(self) -> None:
        """Stop the producer and release queued frames (safe to call on a
        partially consumed pipeline; iteration ends after this)."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    def __del__(self):  # best-effort: don't leak a blocked producer
        try:
            self._stop.set()
        except Exception:
            pass

    def __iter__(self) -> Iterator:
        while True:
            item = self._q.get()
            if item is _SENTINEL:
                if self._err is not None:
                    raise self._err
                return
            yield item

    def __len__(self) -> int:
        return len(self.paths)


def stream_tum(root: str, width: int, height: int, max_frames=None,
               prefetch: int = 4):
    """(FramePipeline, ground-truth poses | None) for a TUM sequence dir."""
    import os

    from .tum import TUMSequence

    seq = TUMSequence(root, max_frames=max_frames)
    paths = [os.path.join(root, rel) for _, rel, _ in seq.entries]
    poses: Optional[List[np.ndarray]] = (
        [p for _, _, p in seq.entries] if seq.has_gt else None
    )
    return FramePipeline(paths, width, height, prefetch=prefetch), poses
