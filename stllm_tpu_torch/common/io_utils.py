"""IO helpers (stllm_tpu/common/io_utils.py): URL detection, cache paths,
json / yaml / pickle / npy savers and loaders, job-id timestamps, and a
cached download that rank 0 fetches while the other ranks wait."""

from __future__ import annotations

import datetime
import hashlib
import json
import os
import pickle
import urllib.parse
import urllib.request
from typing import Any, Optional

import numpy as np
import yaml

from stllm_tpu_torch.common.registry import registry


def now() -> str:
    """Job-id timestamp: YYYYmmddHHM, the minute's last digit dropped."""
    return datetime.datetime.now().strftime("%Y%m%d%H%M")[:-1]


def is_url(input_url: str) -> bool:
    return bool(urllib.parse.urlparse(str(input_url)).scheme) and "://" in str(input_url)


def get_cache_path(rel_path: str) -> str:
    cache = registry.get_path("cache_root")
    return os.path.expanduser(os.path.join(cache, rel_path))


def get_abs_path(rel_path: str) -> str:
    return os.path.join(registry.get_path("library_root"), rel_path)


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def save_json(obj: Any, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def load_yaml_file(path: str) -> Any:
    with open(path) as f:
        return yaml.safe_load(f)


def save_yaml_file(obj: Any, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(obj, f)


def load_pickle(path: str) -> Any:
    with open(path, "rb") as f:
        return pickle.load(f)


def save_pickle(obj: Any, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def load_npy(path: str) -> np.ndarray:
    return np.load(path, allow_pickle=True)


def save_npy(arr: np.ndarray, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.save(path, arr)


def download_cached_file(url: str, check_hash: bool = True,
                         progress: bool = False,
                         cache_dir: Optional[str] = None) -> str:
    """Download ``url`` once into the cache (rank 0 fetches, every rank
    waits at a barrier). Returns the cached local path; raises when the
    file is neither cached nor fetched."""
    from stllm_tpu_torch.tasks.base_task import barrier, is_main_process

    cache_dir = cache_dir or get_cache_path("downloads")
    os.makedirs(cache_dir, exist_ok=True)
    fname = os.path.basename(urllib.parse.urlparse(url).path)
    digest = hashlib.sha256(url.encode()).hexdigest()[:8]
    path = os.path.join(cache_dir, f"{digest}-{fname}")
    if is_main_process() and not os.path.exists(path):
        tmp = path + ".tmp"
        urllib.request.urlretrieve(url, tmp)  # noqa: S310
        os.replace(tmp, path)
    barrier()
    if not os.path.exists(path):
        raise FileNotFoundError(f"{url} not cached at {path} (offline?)")
    return path
