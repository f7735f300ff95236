"""New CLI subcommands: readmap, graph, select-reads, bam2m4."""
import os

import numpy as np
import pytest

from falcon_unzip_tpu.cli import main
from falcon_unzip_tpu.io import bamlite as bl
from falcon_unzip_tpu.io.fasta import read_fasta, write_fasta
from falcon_unzip_tpu.io.serialize import serialize
from falcon_unzip_tpu.utils.simulate import (make_diploid, random_genome,
                                             simulate_reads)


def test_readmap_merges_and_dedups(tmp_path, capsys):
    a = tmp_path / "phased.0"
    b = tmp_path / "phased.1"
    a.write_text("000000F 0 0 r0\n000000F 0 1 r1\n")
    b.write_text("000001F 0 0 r2\n000000F 0 1 r1\n")   # r1 repeated
    out = str(tmp_path / "rid_to_phase.all")
    assert main(["readmap", str(a), str(b), "--out", out]) == 0
    lines = open(out).read().splitlines()
    assert len(lines) == 3
    assert "000001F 0 0 r2" in lines


@pytest.fixture(scope="module")
def diploid_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_dip")
    dip = make_diploid(length=6000, het_rate=0.02, seed=7,
                       het_span=(0.25, 0.75))
    pr = simulate_reads(dip, coverage=14.0, read_len=1800,
                        error_rate=0.0, seed=8)
    write_fasta(str(d / "preads.fa"),
                ((pr.batch.names[i], pr.batch.to_str(i))
                 for i in range(len(pr.batch))))
    return d


def test_phase_then_graph_cli(diploid_dir, tmp_path, capsys):
    d = diploid_dir
    preads = str(d / "preads.fa")
    # build a draft from hap0-ish reads: just phase against a simulated
    # draft = first read extended; instead use pipeline phase subcommand
    # against a draft assembled by the unzip pipeline being overkill here,
    # so make the draft the longest pread's sequence repeated via overlap
    # walk — simplest: use the phase CLI against a draft FASTA of the
    # full-length haplotype reconstructed from simulate's het positions.
    # A cheap stand-in: reuse preads as both reads and a 1-contig draft.
    batch = read_fasta(preads)
    longest = int(np.argmax(batch.lengths))
    write_fasta(str(tmp_path / "draft.fa"),
                [("d0", batch.to_str(longest))])
    phased = str(tmp_path / "phased_reads")
    assert main(["phase", "--preads", preads,
                 "--draft", str(tmp_path / "draft.fa"),
                 "--out", phased]) == 0
    assert os.path.exists(phased)

    out_dir = str(tmp_path / "graphed")
    assert main(["graph", "--preads", preads, "--phased-reads", phased,
                 "--out-dir", out_dir]) == 0
    assert os.path.exists(os.path.join(out_dir, "all_p_ctg.fa"))
    assert os.path.exists(os.path.join(out_dir, "all_h_ctg.fa"))
    p = read_fasta(os.path.join(out_dir, "all_p_ctg.fa"))
    assert len(p) >= 1


def _mk_bam(tmp_path, n=12):
    rng = np.random.default_rng(0)
    recs = []
    for i in range(n):
        L = 60
        recs.append(bl.BamRecord(
            name=f"r{i}", flag=0, ref_id=i % 2,
            pos=int(rng.integers(0, 100)), mapq=60, cigar=[(L, 0)],
            seq=random_genome(L, i), qual=np.full(L, 30, np.uint8)))
    bam = bl.BamFile(text="@HD\tVN:1.6\n",
                     refs=[("c0", 400), ("c1", 400)], records=recs)
    path = str(tmp_path / "in.bam")
    bl.write_bam(path, bam)
    return path


def test_select_reads_cli(tmp_path, capsys):
    path = _mk_bam(tmp_path)
    mp = str(tmp_path / "map.json")
    serialize(mp, {f"r{i}": i % 2 for i in range(8)})
    pattern = str(tmp_path / "part_{}.bam")
    assert main(["select-reads", "--bam", path, "--map", mp,
                 "--out-pattern", pattern]) == 0
    p0 = bl.read_bam(pattern.format(0))
    p1 = bl.read_bam(pattern.format(1))
    assert len(p0.records) + len(p1.records) == 8


def test_bam2m4_cli(tmp_path, capsys):
    path = _mk_bam(tmp_path)
    out = str(tmp_path / "aln.m4")
    assert main(["bam2m4", "--bam", path, "--out", out]) == 0
    from falcon_unzip_tpu.coords import read_m4
    recs = read_m4(out)
    assert len(recs) == 12
    assert all(r.t_name in ("c0", "c1") for r in recs)
