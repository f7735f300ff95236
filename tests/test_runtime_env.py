"""What the program needs from its surroundings: the compile-cache
directory rule, serialization without optional packages, the in-flight
chunk bound, and a smoke script that refuses to run without a GPU."""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from falcon_unzip_tpu.ops import banded_align as ba
from falcon_unzip_tpu.utils import compile_cache as cc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_dir_honours_env():
    assert cc.cache_dir({cc.ENV: "/some/where"}) == "/some/where"


def test_cache_dir_default_is_fixed_inside_checkout():
    a, b = cc.cache_dir({}), cc.cache_dir({})
    assert a == b
    assert a.startswith(os.path.join(ROOT, ".jax_cache") + os.sep)
    assert str(os.getpid()) not in os.path.basename(a)


def test_alnset_round_trip_without_msgpack(monkeypatch):
    monkeypatch.setitem(sys.modules, "msgpack", None)   # import fails
    from falcon_unzip_tpu.models.aligner import AlnSet
    tags = [np.arange(12, dtype=np.int32).reshape(4, 3),
            np.zeros((0, 3), np.int32),
            np.full((2, 3), 7, np.int32)]
    a = AlnSet(read_id=np.array([0, 1, 5], np.int32),
               ctg=np.array([0, 0, 2], np.int32),
               strand=np.array([0, 1, 0], np.int8),
               t_start=np.array([10, 20, 30], np.int64),
               t_end=np.array([110, 220, 330], np.int64),
               q_len=np.array([100, 200, 300], np.int32),
               dist=np.array([1, 2, 3], np.int32), tags=tags,
               q_start=np.array([0, 4, 9], np.int32))
    b = AlnSet.from_bytes(a.to_bytes())
    for k in ("read_id", "ctg", "strand", "t_start", "t_end", "q_len",
              "dist", "q_start"):
        assert getattr(b, k).dtype == getattr(a, k).dtype
        np.testing.assert_array_equal(getattr(b, k), getattr(a, k))
    assert len(b.tags) == 3
    for x, y in zip(a.tags, b.tags):
        np.testing.assert_array_equal(x, y)


def test_read_map_round_trip_without_msgpack(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "msgpack", None)
    from falcon_unzip_tpu.io.serialize import deserialize, serialize
    r2c = {"r0": ["000000F", 3], "r1": ["000001F", np.int64(2)]}
    path = str(tmp_path / "read_to_contig_map.json")
    serialize(path, r2c)
    assert deserialize(path) == {"r0": ["000000F", 3],
                                 "r1": ["000001F", 2]}
    assert not os.path.exists(path + ".tmp")


@pytest.mark.parametrize("chunk,limit,want", [
    (2 * 5120 * 256 * 256, 60 * 2**30, 24),   # read-align chunk, 60 GiB
    (10**12, 80 * 2**30, 1),                  # one chunk beyond a quarter
    (1, 4, 1)])
def test_inflight_limit(chunk, limit, want):
    assert ba.inflight_limit(chunk, limit) == want


def test_max_inflight_follows_device_memory(monkeypatch):
    al = ba.BandedAligner(W=256)
    monkeypatch.setattr(ba, "device_bytes_limit", lambda: 64 * 2**30)
    small = al.max_inflight(256, 1024, 1536)
    big = al.max_inflight(256, 4096, 4608)
    assert small > big >= 1
    monkeypatch.undo()
    assert ba.device_bytes_limit() > 0


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_refuses_cpu():
    r = _run_smoke(ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run_smoke(str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
