"""Download progress events, as the node keeps them for
``GET /v1/download/progress``. Own copy of the reference's
``download/progress.py``.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field


@dataclass
class RepoFileProgressEvent:
  repo_id: str
  repo_revision: str
  file_path: str
  downloaded: int
  downloaded_this_session: int
  total: int
  speed: float
  eta: float
  status: str  # "not_started" | "in_progress" | "complete"

  def to_dict(self) -> dict:
    return asdict(self)

  @classmethod
  def from_dict(cls, data: dict) -> "RepoFileProgressEvent":
    return cls(**{k: data[k] for k in cls.__dataclass_fields__})


@dataclass
class RepoProgressEvent:
  shard: dict
  repo_id: str
  repo_revision: str
  completed_files: int
  total_files: int
  downloaded_bytes: int
  downloaded_bytes_this_session: int
  total_bytes: int
  overall_speed: float
  overall_eta: float
  file_progress: dict[str, RepoFileProgressEvent] = field(default_factory=dict)
  status: str = "not_started"

  def to_dict(self) -> dict:
    d = asdict(self)
    d["file_progress"] = {k: v.to_dict() if isinstance(v, RepoFileProgressEvent) else v for k, v in self.file_progress.items()}
    return d

  @classmethod
  def from_dict(cls, data: dict) -> "RepoProgressEvent":
    data = dict(data)
    data["file_progress"] = {k: RepoFileProgressEvent.from_dict(v) if isinstance(v, dict) else v for k, v in data.get("file_progress", {}).items()}
    return cls(**{k: data[k] for k in cls.__dataclass_fields__ if k in data})
