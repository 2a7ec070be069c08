"""Key-value training logger (the port's own copy of
`sin3dm_tpu/core/logger.py`): `logkv`, `logkv_mean`, `dumpkvs`, the
human-readable, CSV and JSON writers, TensorBoard where `tensorboardX`
imports, `profile_kv` timing contexts and the module-level
`configure()` / `log()` API.  Single-process.
"""

from __future__ import annotations

import csv
import datetime
import json
import os
import tempfile
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List, Optional


class KVWriter:
    def writekvs(self, kvs: Dict) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class HumanOutputWriter(KVWriter):
    def __init__(self, stream):
        self.stream = stream

    def writekvs(self, kvs: Dict) -> None:
        key2str = {}
        for k, v in sorted(kvs.items()):
            vs = f"{v:<8.3g}" if hasattr(v, "__float__") else str(v)
            key2str[self._trunc(k)] = self._trunc(vs)
        if not key2str:
            return
        kw = max(map(len, key2str.keys()))
        vw = max(map(len, key2str.values()))
        dashes = "-" * (kw + vw + 7)
        lines = [dashes]
        for k, v in sorted(key2str.items()):
            lines.append(f"| {k}{' ' * (kw - len(k))} | "
                         f"{v}{' ' * (vw - len(v))} |")
        lines.append(dashes)
        self.stream.write("\n".join(lines) + "\n")
        self.stream.flush()

    @staticmethod
    def _trunc(s: str, maxlen: int = 30) -> str:
        return s[:maxlen - 3] + "..." if len(s) > maxlen else s


class JSONOutputWriter(KVWriter):
    def __init__(self, filename: str):
        self.file = open(filename, "at")

    def writekvs(self, kvs: Dict) -> None:
        out = {k: float(v) if hasattr(v, "__float__") else v
               for k, v in kvs.items()}
        self.file.write(json.dumps(out) + "\n")
        self.file.flush()

    def close(self) -> None:
        self.file.close()


class CSVOutputWriter(KVWriter):
    def __init__(self, filename: str):
        self.filename = filename
        self.keys: List[str] = []
        self.rows: List[Dict] = []

    def writekvs(self, kvs: Dict) -> None:
        extra = sorted(k for k in kvs.keys() if k not in self.keys)
        self.keys.extend(extra)
        self.rows.append(dict(kvs))
        d = os.path.dirname(self.filename)
        if d:
            # the configured log dir may have been removed (e.g. a tmp dir
            # from a prior run) — recreate rather than crash the train loop
            os.makedirs(d, exist_ok=True)
        with open(self.filename, "wt", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self.keys)
            writer.writeheader()
            for row in self.rows:
                writer.writerow({k: row.get(k, "") for k in self.keys})


class TensorBoardOutputWriter(KVWriter):
    """KV dump -> TB scalars (the reference logger's tensorboard format,
    `logger.py:160-204`); uses the dumped 'step' key as global_step."""

    def __init__(self, log_dir: str):
        from tensorboardX import SummaryWriter
        self.writer = SummaryWriter(log_dir)
        self.step = 0

    def writekvs(self, kvs: Dict) -> None:
        step = int(kvs.get("step", self.step))
        for k, v in kvs.items():
            if hasattr(v, "__float__"):
                self.writer.add_scalar(k, float(v), global_step=step)
        self.step = step + 1

    def close(self) -> None:
        self.writer.close()


class Logger:
    def __init__(self, log_dir: Optional[str], writers: List[KVWriter]):
        self.log_dir = log_dir
        self.writers = writers
        self.name2val: Dict[str, float] = defaultdict(float)
        self.name2cnt: Dict[str, int] = defaultdict(int)
        self._start_times: Dict[str, float] = {}

    def logkv(self, key, val) -> None:
        self.name2val[key] = val

    def logkv_mean(self, key, val, count: int = 1) -> None:
        """Running mean; `count` lets device-side bin counts feed in."""
        if count <= 0:
            return
        old, cnt = self.name2val[key], self.name2cnt[key]
        self.name2val[key] = (old * cnt + float(val) * count) / (cnt + count)
        self.name2cnt[key] = cnt + count

    def dumpkvs(self) -> Dict:
        out = dict(self.name2val)
        for w in self.writers:
            w.writekvs(out)
        self.name2val.clear()
        self.name2cnt.clear()
        return out

    def log(self, *args) -> None:
        print(*args)

    @contextmanager
    def profile_kv(self, name: str):
        """Accumulate wall-time under `wait_{name}`
        (`logger.py:293-303` semantics)."""
        start = time.time()
        try:
            yield
        finally:
            self.name2val["wait_" + name] += time.time() - start

    def close(self) -> None:
        for w in self.writers:
            w.close()


_CURRENT: Optional[Logger] = None


def configure(dir: Optional[str] = None,
              format_strs: Optional[List[str]] = None) -> Logger:
    """Set up the module-level logger (env overrides mirror the reference:
    SIN3DM_LOGDIR / SIN3DM_LOG_FORMAT)."""
    global _CURRENT
    import sys
    if dir is None:
        dir = os.environ.get("SIN3DM_LOGDIR")
    if dir is None:
        dir = os.path.join(
            tempfile.gettempdir(),
            datetime.datetime.now().strftime("sin3dm-%Y-%m-%d-%H-%M-%S"))
    os.makedirs(dir, exist_ok=True)
    if format_strs is None:
        format_strs = os.environ.get(
            "SIN3DM_LOG_FORMAT", "stdout,log,csv,json").split(",")
    writers: List[KVWriter] = []
    for fmt in filter(None, format_strs):
        if fmt == "stdout":
            writers.append(HumanOutputWriter(sys.stdout))
        elif fmt == "log":
            writers.append(HumanOutputWriter(
                open(os.path.join(dir, "log.txt"), "at")))
        elif fmt == "json":
            writers.append(JSONOutputWriter(
                os.path.join(dir, "progress.json")))
        elif fmt == "csv":
            writers.append(CSVOutputWriter(os.path.join(dir, "progress.csv")))
        elif fmt == "tensorboard":
            writers.append(TensorBoardOutputWriter(
                os.path.join(dir, "tb")))
        else:
            raise ValueError(f"unknown log format: {fmt}")
    _CURRENT = Logger(dir, writers)
    _CURRENT.log(f"Logging to {dir}")
    return _CURRENT


def get_current() -> Logger:
    global _CURRENT
    if _CURRENT is None:
        _CURRENT = configure()
    return _CURRENT


def logkv(key, val):
    get_current().logkv(key, val)


def logkv_mean(key, val, count: int = 1):
    get_current().logkv_mean(key, val, count)


def dumpkvs():
    return get_current().dumpkvs()


def log(*args):
    get_current().log(*args)


def get_dir() -> Optional[str]:
    return get_current().log_dir


@contextmanager
def profile_kv(name: str):
    with get_current().profile_kv(name):
        yield


def profile(name: str):
    """Decorator: accumulate the wrapped function's wall time under
    `wait_{name}` (reference `logger.py:306-317`)."""
    def decorator(fn):
        def wrapped(*args, **kwargs):
            with profile_kv(name):
                return fn(*args, **kwargs)
        return wrapped
    return decorator
