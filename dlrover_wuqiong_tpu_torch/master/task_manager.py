"""Dynamic data sharding: shard queue, dispatch, recovery of failed-worker shards.

Parity: dlrover_wuqiong_tpu/master/task_manager.py, copied whole (stdlib
only): `DatasetManager`'s todo / doing bookkeeping, the worker-facing
shard checkpoint (`to_checkpoint`, `from_checkpoint`), the journal's
exact snapshot (`export_state`, `from_state`) and replay
(`replay_dispatch`, `replay_task_result`), and `TaskManager` with its
hang signal.  (The JAX module's own parity: reference
`dlrover/python/master/shard/task_manager.py`, TaskManager :37.)
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..common.constants import TaskType
from ..common.log import get_logger
from .dataset_splitter import DatasetSplitter, Shard, new_dataset_splitter

logger = get_logger("task_manager")


@dataclass
class DatasetTask:
    task_id: int
    task_type: str
    shard: Shard


@dataclass
class DoingTask:
    task: DatasetTask
    node_id: int
    start_time: float


class DatasetManager:
    """Todo/doing/done bookkeeping for one named dataset."""

    def __init__(self, task_type: str, batch_size: int,
                 splitter: DatasetSplitter):
        self.task_type = task_type
        self.batch_size = batch_size
        self.splitter = splitter
        self.todo: List[DatasetTask] = []
        self.doing: Dict[int, DoingTask] = {}
        self._task_id = 0
        self._completed_step = 0

    def create_tasks(self):
        self.splitter.create_shards()
        for shard in self.splitter.get_shards():
            self.todo.append(DatasetTask(self._task_id, self.task_type, shard))
            self._task_id += 1

    def get_task(self, node_id: int) -> Optional[DatasetTask]:
        if not self.todo:
            if not self.splitter.epoch_finished():
                self.create_tasks()
        if not self.todo:
            return None
        task = self.todo.pop(0)
        self.doing[task.task_id] = DoingTask(task, node_id, time.time())
        return task

    def report_task_done(self, task_id: int, success: bool) -> bool:
        doing = self.doing.pop(task_id, None)
        if doing is None:
            return False
        if not success:
            self.todo.insert(0, doing.task)
            return False
        return True

    def recover_node_tasks(self, node_id: int) -> int:
        """Re-queue shards a dead worker was processing (shard-level recovery)."""
        recovered = [tid for tid, d in self.doing.items()
                     if d.node_id == node_id]
        for tid in recovered:
            doing = self.doing.pop(tid)
            self.todo.insert(0, doing.task)
        if recovered:
            logger.info("recovered %d in-flight shards from node %s",
                        len(recovered), node_id)
        return len(recovered)

    def completed(self) -> bool:
        return (not self.todo and not self.doing
                and self.splitter.epoch_finished())

    def to_checkpoint(self) -> Dict:
        return {
            "splitter": self.splitter.to_checkpoint(),
            "task_type": self.task_type,
            "batch_size": self.batch_size,
            "todo": [[t.shard.start, t.shard.end, t.shard.record_indices]
                     for t in self.todo]
                    + [[d.task.shard.start, d.task.shard.end,
                        d.task.shard.record_indices]
                       for d in self.doing.values()],
        }

    @classmethod
    def from_checkpoint(cls, data: Dict) -> "DatasetManager":
        splitter = DatasetSplitter.from_checkpoint(data["splitter"])
        mgr = cls(data["task_type"], data["batch_size"], splitter)
        for start, end, indices in data.get("todo", []):
            mgr.todo.append(
                DatasetTask(mgr._task_id, mgr.task_type,
                            Shard(splitter.dataset_name, start, end,
                                  indices or [])))
            mgr._task_id += 1
        return mgr

    # ------------------------------------------------------- journal replay

    def export_state(self) -> Dict:
        """Exact snapshot for the master journal: unlike `to_checkpoint`
        (worker-facing, merges doing into todo and renumbers), this keeps
        task IDS and the doing map so a restarted master can still match a
        worker's in-flight `report_task_result` — the no-double-train
        invariant (master/journal.py)."""
        return {
            "splitter": self.splitter.to_checkpoint(),
            "task_type": self.task_type,
            "batch_size": self.batch_size,
            "next_task_id": self._task_id,
            "todo": [[t.task_id, t.shard.start, t.shard.end,
                      t.shard.record_indices] for t in self.todo],
            "doing": [[d.task.task_id, d.node_id, d.task.shard.start,
                       d.task.shard.end, d.task.shard.record_indices]
                      for d in self.doing.values()],
        }

    @classmethod
    def from_state(cls, data: Dict) -> "DatasetManager":
        splitter = DatasetSplitter.from_checkpoint(data["splitter"])
        mgr = cls(data["task_type"], data["batch_size"], splitter)
        mgr._task_id = int(data.get("next_task_id", 0))
        name = splitter.dataset_name
        for tid, start, end, indices in data.get("todo", []):
            mgr.todo.append(DatasetTask(
                tid, mgr.task_type, Shard(name, start, end, indices or [])))
        for tid, node_id, start, end, indices in data.get("doing", []):
            mgr.doing[tid] = DoingTask(
                DatasetTask(tid, mgr.task_type,
                            Shard(name, start, end, indices or [])),
                node_id, time.time())
        return mgr

    def replay_dispatch(self, task_id: int, node_id: int, start: int,
                        end: int, indices: Optional[List[int]] = None):
        """Re-apply a journaled `get_task` dispatch: move the task from
        todo to doing(node).  Shard creation on epoch rollover is
        reproduced (splitter shuffles are seeded, dataset_splitter.py),
        and a task the replayed todo does not hold is synthesized from the
        journal's own shard payload — the journal is authoritative."""
        if task_id in self.doing:
            return
        task = self._pop_todo(task_id)
        if task is None and not self.todo \
                and not self.splitter.epoch_finished():
            self.create_tasks()  # the rollover get_task() triggered live
            task = self._pop_todo(task_id)
        if task is None:
            task = DatasetTask(
                task_id, self.task_type,
                Shard(self.splitter.dataset_name, start, end, indices or []))
            # drop any todo entry covering the same range — it IS this task
            self.todo = [t for t in self.todo
                         if not (t.shard.start == start
                                 and t.shard.end == end)]
        self._task_id = max(self._task_id, task_id + 1)
        self.doing[task_id] = DoingTask(task, node_id, time.time())

    def _pop_todo(self, task_id: int) -> Optional[DatasetTask]:
        for i, t in enumerate(self.todo):
            if t.task_id == task_id:
                return self.todo.pop(i)
        return None


class TaskManager:
    """Dispatches dataset shards to workers; detects task hang.

    Parity: reference task_manager.py:37 (+ `reset_worker_start_task_time`
    hang signal used by the diagnosis subsystem).
    """

    def __init__(self, worker_restart_timeout: float = 0.0):
        self._lock = threading.Lock()
        self._datasets: Dict[str, DatasetManager] = {}
        self._worker_start_task_time: Dict[int, float] = {}
        self._task_timeout_callbacks: List[Callable] = []
        self._worker_restart_timeout = worker_restart_timeout
        self.speed_monitor = None  # wired by the master

    def new_dataset(self, batch_size: int, dataset_size: int,
                    dataset_name: str, num_epochs: int = 1,
                    shuffle: bool = False,
                    num_minibatches_per_shard: int = 2,
                    storage_type: str = "",
                    task_type: str = TaskType.TRAINING) -> bool:
        """Create the dataset; returns False when it already exists (the
        journal records only the first creation)."""
        with self._lock:
            if dataset_name in self._datasets:
                return False
            splitter = new_dataset_splitter(
                storage_type, shuffle, dataset_size, batch_size, num_epochs,
                num_minibatches_per_shard, dataset_name)
            mgr = DatasetManager(task_type, batch_size, splitter)
            mgr.create_tasks()
            self._datasets[dataset_name] = mgr
            logger.info("new dataset %s: size=%d shards=%d", dataset_name,
                        dataset_size, len(mgr.todo))
            return True

    def get_dataset_task(self, node_id: int,
                         dataset_name: str) -> Optional[DatasetTask]:
        with self._lock:
            mgr = self._datasets.get(dataset_name)
            if mgr is None:
                return None
            task = mgr.get_task(node_id)
            if task is not None:
                self._worker_start_task_time[node_id] = time.time()
            return task

    def report_dataset_task(self, node_id: int, dataset_name: str,
                            task_id: int, success: bool) -> bool:
        with self._lock:
            mgr = self._datasets.get(dataset_name)
            if mgr is None:
                return False
            self._worker_start_task_time[node_id] = time.time()
            return mgr.report_task_done(task_id, success)

    def recover_tasks(self, node_id: int):
        with self._lock:
            for mgr in self._datasets.values():
                mgr.recover_node_tasks(node_id)

    def finished(self, dataset_name: Optional[str] = None) -> bool:
        with self._lock:
            if dataset_name:
                mgr = self._datasets.get(dataset_name)
                return mgr.completed() if mgr else True
            return all(m.completed() for m in self._datasets.values())

    def reset_worker_start_task_time(self, node_id: int):
        with self._lock:
            self._worker_start_task_time[node_id] = time.time()

    def task_hanged(self, timeout: float = 1800.0) -> bool:
        """True if every worker with in-flight tasks is silent past timeout."""
        with self._lock:
            doing_nodes = set()
            for mgr in self._datasets.values():
                doing_nodes.update(d.node_id for d in mgr.doing.values())
            if not doing_nodes:
                return False
            now = time.time()
            return all(
                now - self._worker_start_task_time.get(nid, now) > timeout
                for nid in doing_nodes)

    # ------------------------------------------------------- journal replay

    def export_state(self) -> Dict:
        with self._lock:
            return {name: mgr.export_state()
                    for name, mgr in self._datasets.items()}

    def restore_state(self, data: Dict):
        with self._lock:
            for name, mgr_data in data.items():
                self._datasets[name] = DatasetManager.from_state(mgr_data)

    def replay_dispatch(self, dataset_name: str, task_id: int, node_id: int,
                        start: int, end: int,
                        indices: Optional[List[int]] = None):
        with self._lock:
            mgr = self._datasets.get(dataset_name)
            if mgr is not None:
                mgr.replay_dispatch(task_id, node_id, start, end, indices)

    def replay_task_result(self, dataset_name: str, task_id: int,
                           success: bool):
        with self._lock:
            mgr = self._datasets.get(dataset_name)
            if mgr is not None:
                mgr.report_task_done(task_id, success)

    def get_dataset_checkpoint(self, dataset_name: str) -> str:
        with self._lock:
            mgr = self._datasets.get(dataset_name)
            if mgr is None:
                return ""
            return json.dumps(mgr.to_checkpoint())

    def restore_dataset_from_checkpoint(self, content: str) -> bool:
        try:
            data = json.loads(content)
            mgr = DatasetManager.from_checkpoint(data)
            with self._lock:
                self._datasets[mgr.splitter.dataset_name] = mgr
            return True
        except (ValueError, KeyError) as e:
            logger.warning("failed to restore dataset checkpoint: %s", e)
            return False
