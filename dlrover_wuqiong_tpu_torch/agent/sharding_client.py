"""Worker-side dynamic-sharding client with prefetch.

Parity: dlrover_wuqiong_tpu/agent/sharding_client.py, copied whole
(stdlib only): `ShardingClient` (report the dataset's shard params, then
fetch a shard, report it done or failed, read or restore the dataset's
shard checkpoint) and `IndexShardingClient` (per-sample indices, a task
reported once all its samples were consumed), over the port's
`MasterClient` verbs.  (The JAX module's own parity: reference
`dlrover/python/elastic_agent/sharding/client.py`, ShardingClient :29,
IndexShardingClient :231.)
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, List, Optional

from ..common.log import get_logger
from .master_client import MasterClient

logger = get_logger("sharding_client")


class ShardingClient:
    """Fetch/report shard tasks for one dataset."""

    def __init__(self, master_client: MasterClient, dataset_name: str,
                 batch_size: int, dataset_size: int, num_epochs: int = 1,
                 shuffle: bool = False, num_minibatches_per_shard: int = 2,
                 storage_type: str = "", task_type: str = "training"):
        self._mc = master_client
        self.dataset_name = dataset_name
        self._mc.report_dataset_shard_params(
            batch_size=batch_size, num_epochs=num_epochs,
            dataset_size=dataset_size, shuffle=shuffle,
            num_minibatches_per_shard=num_minibatches_per_shard,
            dataset_name=dataset_name, task_type=task_type,
            storage_type=storage_type)
        self._current_task = None

    def fetch_shard(self, wait: bool = True, timeout: float = 600.0):
        """Returns a Task with a shard, or None when the dataset is finished."""
        deadline = time.monotonic() + timeout
        while True:
            task = self._mc.get_task(self.dataset_name)
            if task.task_type == "wait":
                if not wait or time.monotonic() > deadline:
                    return None
                time.sleep(0.5)
                continue
            if task.task_id < 0:
                return None
            self._current_task = task
            return task

    def report_shard_done(self, task_id: Optional[int] = None):
        tid = task_id if task_id is not None else (
            self._current_task.task_id if self._current_task else -1)
        if tid >= 0:
            self._mc.report_task_result(self.dataset_name, tid)

    def report_shard_error(self, err: str, task_id: Optional[int] = None):
        tid = task_id if task_id is not None else (
            self._current_task.task_id if self._current_task else -1)
        if tid >= 0:
            self._mc.report_task_result(self.dataset_name, tid,
                                        err_message=err)

    def get_checkpoint(self) -> str:
        return self._mc.get_shard_checkpoint(self.dataset_name)

    def restore_checkpoint(self, content: str):
        self._mc.report_shard_checkpoint(content)


class IndexShardingClient(ShardingClient):
    """Streams per-sample indices with a background prefetch thread.

    Parity: reference IndexShardingClient (:231) — `fetch_sample_index` feeds
    dataset __getitem__ with globally-sharded indices.
    """

    def __init__(self, *args, prefetch_shards: int = 2, **kwargs):
        super().__init__(*args, **kwargs)
        self._index_queue: "queue.Queue" = queue.Queue(maxsize=100000)
        self._pending: List[int] = []
        self._task_ids: "queue.Queue" = queue.Queue()
        self._fetch_lock = threading.Lock()
        self._finished = False

    def fetch_sample_index(self) -> Optional[int]:
        while True:
            try:
                return self._index_queue.get_nowait()
            except queue.Empty:
                with self._fetch_lock:
                    if self._finished:
                        return None
                    task = self.fetch_shard(wait=True)
                    if task is None:
                        self._finished = True
                        return None
                    indices = task.shard.indices or list(
                        range(task.shard.start, task.shard.end))
                    for idx in indices:
                        self._index_queue.put(idx)
                    self._task_ids.put((task.task_id, len(indices)))

    def report_batch_done(self, batch_size: int):
        """Report completed tasks once all their samples were consumed."""
        self._consumed = getattr(self, "_consumed", 0) + batch_size
        while not self._task_ids.empty():
            tid, n = self._task_ids.queue[0]
            if self._consumed >= n:
                self._task_ids.get()
                self._consumed -= n
                self.report_shard_done(tid)
            else:
                break
