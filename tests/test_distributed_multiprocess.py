"""True multi-process jax.distributed test (SURVEY.md §4: multi-host via
multiprocess CPU so no pod is needed).

Two OS processes each own 2 virtual CPU devices and join one
jax.distributed world (GRPC coordinator = the cross-host network stand-in); a psum over
the global 4-device mesh and the sharded pileup must see ALL processes'
data.  This exercises the cross-host path that single-process mesh tests
cannot (process coordination, global device enumeration, cross-process
collectives).
"""
import os
import socket
import subprocess
import sys

import pytest

_WORKER = r"""
import os, sys
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=2").strip()
import jax
jax.config.update("jax_platforms", "cpu")
pid = int(sys.argv[1]); port = sys.argv[2]
from falcon_unzip_tpu.parallel.distributed import initialize
initialize(coordinator_address=f"localhost:{port}", num_processes=2,
           process_id=pid)
import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
assert jax.process_count() == 2, jax.process_count()
assert jax.device_count() == 4, jax.device_count()

mesh = Mesh(np.array(jax.devices()).reshape(4, 1), ("data", "window"))

# global psum: every process contributes its local shard
from jax import shard_map
@jax.jit
@lambda f: shard_map(f, mesh=mesh, in_specs=P(("data", "window")),
                     out_specs=P())
def total(x):
    return jax.lax.psum(x.sum(), ("data", "window"))

# a global (8,) array: each process supplies its local half via
# make_array_from_process_local_data
sharding = NamedSharding(mesh, P(("data", "window")))
local = np.full(4, 1 + jax.process_index(), np.int32)   # proc0: 1s, proc1: 2s
garr = jax.make_array_from_process_local_data(sharding, local, (8,))
out = int(jax.device_get(total(garr)))
assert out == 4 * 1 + 4 * 2, out     # sees BOTH processes' data
print(f"OK process={jax.process_index()} total={out}", flush=True)
"""


_PIPELINE_WORKER = r"""
import os, sys
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=2").strip()
import jax
jax.config.update("jax_platforms", "cpu")
d = sys.argv[1]
from falcon_unzip_tpu.config import PipelineConfig
from falcon_unzip_tpu.pipeline.quiver import run_quiver
from falcon_unzip_tpu.pipeline.unzip import run_unzip
cfg = PipelineConfig(preads=f"{d}/preads.fa", reads=f"{d}/raw.fa",
                     draft=f"{d}/draft.fa", out_dir=f"{d}/out_mp")
cfg.mesh.multihost = True      # initialize() from JAX_* env vars
run_unzip(cfg)
run_quiver(cfg)
# resume pass: every stage must SKIP identically on every host (the
# sync_stage_done broadcast) — a divergent decision would deadlock in
# the first collective and trip the test timeout
run_unzip(cfg)
run_quiver(cfg)
print(f"WORKER-OK process={jax.process_index()}", flush=True)
"""

# canonical artifacts that must be byte-identical between the
# single-process and the 2-host run (host 0 emits them)
_COMPARE = [
    "3-unzip/all_p_ctg.fa", "3-unzip/all_h_ctg.fa",
    "3-unzip/all_phased_reads", "3-unzip/all_h_ctg_ids",
    "3-unzip/h_ctg_placements.m4", "3-unzip/sg_edges_list",
    "3-unzip/preads.ovl",
    "4-polish/cns_p_ctg.fasta", "4-polish/cns_p_ctg.fastq",
    "4-polish/cns_h_ctg.fasta", "4-polish/cns_h_ctg.fastq",
]


@pytest.mark.slow
def test_two_process_full_pipeline_byte_identical(tmp_path):
    """The VERDICT #1 gate: the FULL 3-unzip + 4-polish pipeline over a
    2-process x 2-device jax.distributed world emits byte-identical
    canonical artifacts vs the single-process run (SURVEY.md §2c cluster
    fan-out row; BASELINE.json bit-identical north star)."""
    from falcon_unzip_tpu.config import PipelineConfig
    from falcon_unzip_tpu.io.fasta import write_fasta
    from falcon_unzip_tpu.pipeline.quiver import run_quiver
    from falcon_unzip_tpu.pipeline.unzip import run_unzip
    from falcon_unzip_tpu.seq import decode
    from falcon_unzip_tpu.utils.simulate import make_diploid, simulate_reads

    d = str(tmp_path)
    dip = make_diploid(length=4000, het_rate=0.02, seed=11,
                       het_span=(0.25, 0.75))
    pr = simulate_reads(dip, coverage=12.0, read_len=1500,
                        error_rate=0.0, seed=12)
    raw = simulate_reads(dip, coverage=14.0, read_len=1200,
                         error_rate=0.03, seed=13)
    write_fasta(f"{d}/preads.fa",
                ((pr.batch.names[i], pr.batch.to_str(i))
                 for i in range(len(pr.batch))))
    write_fasta(f"{d}/raw.fa",
                ((raw.batch.names[i], raw.batch.to_str(i))
                 for i in range(len(raw.batch))))
    write_fasta(f"{d}/draft.fa", [("d0", decode(dip.hap0))])

    # ---- single-process reference run (in this pytest process)
    cfg = PipelineConfig(preads=f"{d}/preads.fa", reads=f"{d}/raw.fa",
                         draft=f"{d}/draft.fa", out_dir=f"{d}/out_sp")
    run_unzip(cfg)
    run_quiver(cfg)

    # ---- 2-process x 2-virtual-device multihost run
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for i in range(2):
        env = dict(os.environ)
        env.pop("JAX_PLATFORMS", None)
        env["JAX_COORDINATOR_ADDRESS"] = f"localhost:{port}"
        env["JAX_NUM_PROCESSES"] = "2"
        env["JAX_PROCESS_ID"] = str(i)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _PIPELINE_WORKER, d],
            cwd=repo, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multihost pipeline worker timed out")
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-3000:]}"
        assert "WORKER-OK" in out, out[-500:]

    mismatches = []
    for rel in _COMPARE:
        sp = open(os.path.join(d, "out_sp", rel), "rb").read()
        mp = open(os.path.join(d, "out_mp", rel), "rb").read()
        if sp != mp:
            mismatches.append(rel)
    assert not mismatches, (
        "multihost outputs diverged from single-process run: "
        + ", ".join(mismatches))


_KILLED_WORKER = r"""
import os, signal, sys
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=2").strip()
import jax
jax.config.update("jax_platforms", "cpu")
d = sys.argv[1]
from falcon_unzip_tpu.config import PipelineConfig
from falcon_unzip_tpu.pipeline.unzip import run_unzip
import falcon_unzip_tpu.pipeline.unzip as U

# fault injection: worker 0 SIGKILLs ITSELF (no cleanup, no marker
# writes) at the first per-contig phasing call — mid 2-phasing stage,
# after 1-align completed.  (Host 0 is the contig owner of the test's
# single draft contig, so it is the worker inside the per-contig loop.)
if os.environ["JAX_PROCESS_ID"] == "0":
    def _die(*a, **k):
        print("INJECTING-SIGKILL", flush=True)
        os.kill(os.getpid(), signal.SIGKILL)
    U.phase_contig_device = _die

cfg = PipelineConfig(preads=f"{d}/preads.fa", reads=f"{d}/raw.fa",
                     draft=f"{d}/draft.fa", out_dir=f"{d}/out_mp")
cfg.mesh.multihost = True
run_unzip(cfg)
print(f"WORKER-OK process={jax.process_index()}", flush=True)
"""

_RESUME_WORKER = r"""
import os, sys
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=2").strip()
import jax
jax.config.update("jax_platforms", "cpu")
d = sys.argv[1]
from falcon_unzip_tpu.config import PipelineConfig
from falcon_unzip_tpu.pipeline.quiver import run_quiver
from falcon_unzip_tpu.pipeline.unzip import run_unzip
cfg = PipelineConfig(preads=f"{d}/preads.fa", reads=f"{d}/raw.fa",
                     draft=f"{d}/draft.fa", out_dir=f"{d}/out_mp")
cfg.mesh.multihost = True
run_unzip(cfg)
run_quiver(cfg)
print(f"WORKER-OK process={jax.process_index()}", flush=True)
"""


def _spawn_workers(script, d, port, n=2):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for i in range(n):
        env = dict(os.environ)
        env.pop("JAX_PLATFORMS", None)
        env["JAX_COORDINATOR_ADDRESS"] = f"localhost:{port}"
        env["JAX_NUM_PROCESSES"] = str(n)
        env["JAX_PROCESS_ID"] = str(i)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", script, d], cwd=repo, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_worker_sigkill_then_resume_byte_identical(tmp_path):
    """Fault injection (SURVEY.md §5 failure-detection row): worker 1 is
    SIGKILLed mid 2-phasing (no cleanup), the surviving worker is torn
    down, and a fresh 2-process relaunch resumes from the durable stage
    markers to artifacts byte-identical with the single-process run."""
    from falcon_unzip_tpu.config import PipelineConfig
    from falcon_unzip_tpu.io.fasta import write_fasta
    from falcon_unzip_tpu.pipeline.quiver import run_quiver
    from falcon_unzip_tpu.pipeline.unzip import run_unzip
    from falcon_unzip_tpu.seq import decode
    from falcon_unzip_tpu.utils.simulate import make_diploid, simulate_reads

    d = str(tmp_path)
    dip = make_diploid(length=3000, het_rate=0.02, seed=41,
                       het_span=(0.25, 0.75))
    pr = simulate_reads(dip, coverage=10.0, read_len=1200,
                        error_rate=0.0, seed=42)
    raw = simulate_reads(dip, coverage=12.0, read_len=1000,
                         error_rate=0.03, seed=43)
    write_fasta(f"{d}/preads.fa",
                ((pr.batch.names[i], pr.batch.to_str(i))
                 for i in range(len(pr.batch))))
    write_fasta(f"{d}/raw.fa",
                ((raw.batch.names[i], raw.batch.to_str(i))
                 for i in range(len(raw.batch))))
    write_fasta(f"{d}/draft.fa", [("d0", decode(dip.hap0))])

    cfg = PipelineConfig(preads=f"{d}/preads.fa", reads=f"{d}/raw.fa",
                         draft=f"{d}/draft.fa", out_dir=f"{d}/out_sp")
    run_unzip(cfg)
    run_quiver(cfg)

    # ---- attempt 1: worker 0 (the contig's owner) dies by SIGKILL
    # mid-stage
    procs = _spawn_workers(_KILLED_WORKER, d, _free_port())
    out0, _ = procs[0].communicate(timeout=600)
    assert procs[0].returncode == -9, (procs[0].returncode, out0[-2000:])
    assert "INJECTING-SIGKILL" in out0
    assert "WORKER-OK" not in out0
    # the survivor is blocked in the phasing-table gather; failure
    # detection (the job supervisor role) tears it down
    try:
        out1, _ = procs[1].communicate(timeout=20)
    except subprocess.TimeoutExpired:
        procs[1].kill()
        out1, _ = procs[1].communicate()
    assert "WORKER-OK" not in out1, out1[-1000:]
    # the killed stage left no done marker
    assert not os.path.exists(
        os.path.join(d, "out_mp", "3-unzip", "2-phasing",
                     "stage.done.json"))

    # ---- attempt 2: fresh relaunch resumes and completes
    procs = _spawn_workers(_RESUME_WORKER, d, _free_port())
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("resume worker timed out")
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"resume worker {i} failed:\n{out[-3000:]}"
        assert "WORKER-OK" in out, out[-500:]

    mismatches = []
    for rel in _COMPARE:
        sp = open(os.path.join(d, "out_sp", rel), "rb").read()
        mp = open(os.path.join(d, "out_mp", rel), "rb").read()
        if sp != mp:
            mismatches.append(rel)
    assert not mismatches, (
        "post-crash resume diverged from single-process run: "
        + ", ".join(mismatches))


@pytest.mark.slow
def test_two_process_distributed_psum(tmp_path):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(i), str(port)],
        cwd=repo, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed worker timed out")
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-2000:]}"
        assert f"total={12}" in out, out[-500:]
