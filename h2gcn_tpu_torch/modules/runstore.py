"""A content-addressed run store with signac's layout and no dependency.

The port's copy of the JAX package's run store, so that a project written
by either package is read by the other:

* a *statepoint* (dict of config values) hashes to a stable job id: md5 of
  the key-sorted JSON, the same id in both packages;
* each job owns a workspace directory with a JSON ``doc`` (small metadata,
  e.g. ``succeeded`` flags) and a ``data`` store (numpy arrays saved as
  ``.npy`` under nested keys: activations, predictions, masks);
* a project enumerates and filters its jobs for summaries.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import numpy as np


def calc_id(statepoint: dict) -> str:
    blob = json.dumps(statepoint, sort_keys=True, default=str)
    return hashlib.md5(blob.encode()).hexdigest()[:32]


class JobDoc:
    """Dict-like JSON document persisted next to the job workspace."""

    def __init__(self, path: Path):
        self._path = path

    def _load(self) -> dict:
        if self._path.exists():
            with open(self._path) as f:
                return json.load(f)
        return {}

    def _save(self, d: dict):
        self._path.parent.mkdir(parents=True, exist_ok=True)
        with open(self._path, "w") as f:
            json.dump(d, f, default=str)

    def __getitem__(self, key):
        return self._load()[key]

    def __setitem__(self, key, value):
        d = self._load()
        d[key] = value
        self._save(d)

    def __contains__(self, key):
        return key in self._load()

    def get(self, key, default=None):
        return self._load().get(key, default)

    def update(self, other: dict):
        d = self._load()
        d.update(other)
        self._save(d)

    def items(self):
        return self._load().items()

    def __iter__(self):
        return iter(self._load())


class JobData:
    """Array store: ``data["a/b"] = arr`` → ``<ws>/data/a/b.npy``."""

    def __init__(self, root: Path):
        self._root = root

    def _path(self, key: str) -> Path:
        return self._root / (key.strip("/") + ".npy")

    def __setitem__(self, key, value):
        p = self._path(key)
        p.parent.mkdir(parents=True, exist_ok=True)
        if isinstance(value, dict):  # sparse-tensor style nested dicts
            for k, v in value.items():
                self[f"{key}/{k}"] = v
            return
        np.save(p, np.asarray(value))

    def __getitem__(self, key):
        p = self._path(key)
        if not p.exists():
            raise KeyError(key)
        return np.load(p, allow_pickle=False)

    def __contains__(self, key):
        return self._path(key).exists()

    def keys(self):
        if not self._root.exists():
            return
        for dirpath, _, files in os.walk(self._root):
            for fn in files:
                if fn.endswith(".npy"):
                    full = Path(dirpath) / fn
                    yield str(full.relative_to(self._root))[: -len(".npy")]


class Job:
    def __init__(self, project: "Project", statepoint: dict):
        self._project = project
        self.statepoint = dict(statepoint)
        self.id = calc_id(self.statepoint)
        self._ws = Path(project.workspace_root) / self.id
        self.doc = JobDoc(self._ws / "job_document.json")
        self.data = JobData(self._ws / "data")

    @property
    def sp(self):
        return _SPView(self.statepoint)

    def init(self) -> "Job":
        self._ws.mkdir(parents=True, exist_ok=True)
        sp_file = self._ws / "statepoint.json"
        if not sp_file.exists():
            with open(sp_file, "w") as f:
                json.dump(self.statepoint, f, sort_keys=True, default=str)
        return self

    def workspace(self) -> str:
        return str(self._ws)

    def fn(self, name: str) -> str:
        return str(self._ws / name)

    def isfile(self, name: str) -> bool:
        return (self._ws / name).exists()

    def __eq__(self, other):
        return isinstance(other, Job) and other.id == self.id

    def __hash__(self):
        return hash(self.id)


class _SPView:
    """Attribute-style view over a statepoint dict (signac ``job.sp``)."""

    def __init__(self, d):
        object.__setattr__(self, "_d", d)

    def __getattr__(self, name):
        try:
            return self._d[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __getitem__(self, name):
        return self._d[name]

    def get(self, name, default=None):
        return self._d.get(name, default)

    def keys(self):
        return self._d.keys()


class Project:
    def __init__(self, root: str, create: bool = True):
        self.root = str(Path(root).absolute())
        self.workspace_root = str(Path(self.root) / "workspace")
        if not create:
            return
        Path(self.workspace_root).mkdir(parents=True, exist_ok=True)
        cfg = Path(self.root) / "runstore.json"
        if not cfg.exists():
            with open(cfg, "w") as f:
                json.dump({"schema": 1}, f)

    def open_job(self, statepoint: dict) -> Job:
        return Job(self, statepoint)

    def _load_job(self, job_id: str) -> Job:
        sp_file = Path(self.workspace_root) / job_id / "statepoint.json"
        with open(sp_file) as f:
            return Job(self, json.load(f))

    def __iter__(self):
        ws = Path(self.workspace_root)
        if not ws.exists():
            return
        for d in sorted(ws.iterdir()):
            if (d / "statepoint.json").exists():
                yield self._load_job(d.name)

    def find_jobs(self, sp_filter: dict = None, doc_filter: dict = None):
        for job in self:
            if sp_filter and any(
                job.statepoint.get(k) != v for k, v in sp_filter.items()
            ):
                continue
            if doc_filter and any(job.doc.get(k) != v for k, v in doc_filter.items()):
                continue
            yield job

    def __len__(self):
        return sum(1 for _ in self)


def get_project(root=None, create: bool = True) -> Project:
    """The project at ``root`` (default: the working directory); with
    ``create`` it makes the workspace and the project's config file."""
    root = root or os.getcwd()
    return Project(root, create=create)
