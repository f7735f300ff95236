"""Native C++ FASTX parser == pure-Python reader."""
import numpy as np
import pytest

from falcon_unzip_tpu.io import native
from falcon_unzip_tpu.io.fasta import read_fasta, write_fasta, write_fastq
from falcon_unzip_tpu.utils.simulate import random_genome
from falcon_unzip_tpu.seq import decode

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native lib not built")


def test_native_fasta_matches_python(tmp_path):
    seqs = [random_genome(int(l), s) for s, l in
            enumerate((100, 250, 77, 1024))]
    path = str(tmp_path / "x.fa")
    write_fasta(path, ((f"s{i}", decode(s)) for i, s in enumerate(seqs)))
    a = read_fasta(path)
    b = native.read_fasta_native(path)
    assert a.names == b.names
    assert np.array_equal(a.lengths, b.lengths)
    for i in range(len(a)):
        assert np.array_equal(a.row(i), b.row(i))


def test_native_fastq(tmp_path):
    seqs = [random_genome(50, s + 9) for s in range(3)]
    path = str(tmp_path / "x.fq")
    write_fastq(path, ((f"q{i}", decode(s), "I" * len(s))
                       for i, s in enumerate(seqs)))
    b = native.read_fasta_native(path)
    assert len(b) == 3
    for i in range(3):
        assert np.array_equal(b.row(i), seqs[i])


def _mk_bam(n=25, seed=3):
    from falcon_unzip_tpu.io import bamlite as bl
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        L = int(rng.integers(40, 300))
        recs.append(bl.BamRecord(
            name=f"zmw/{i}/0_{L}", flag=0 if i % 2 else 16,
            ref_id=i % 3, pos=int(rng.integers(0, 2000)), mapq=60,
            cigar=[(L // 2, 0), (3, 1), (L - L // 2, 0)],
            seq=random_genome(L, seed + i),
            qual=rng.integers(5, 45, size=L).astype(np.uint8)))
    return bl.BamFile(text="@HD\tVN:1.6\n@PG\tID:fu\n",
                      refs=[("c0", 9000), ("c1", 7000), ("c2", 5000)],
                      records=recs)


def test_native_bam_decode_matches_python(tmp_path):
    from falcon_unzip_tpu.io import bamlite as bl
    bam = _mk_bam()
    path = str(tmp_path / "n.bam")
    bl.write_bam(path, bam)
    ref = bl.read_bam(path)                 # pure-python decode
    cols = native.read_bam_native(path)     # C++ columnar decode
    assert cols.text == ref.text
    assert cols.refs == ref.refs
    assert len(cols) == len(ref.records)
    back = cols.to_bamfile()
    for a, b in zip(ref.records, back.records):
        assert a.name == b.name and a.flag == b.flag
        assert a.ref_id == b.ref_id and a.pos == b.pos
        assert a.mapq == b.mapq and a.cigar == b.cigar
        assert np.array_equal(a.seq, b.seq)
        assert np.array_equal(a.qual, b.qual)


def test_native_bgzf_encode_roundtrip(tmp_path):
    from falcon_unzip_tpu.io import bamlite as bl
    payload = bytes(np.random.default_rng(7).integers(
        0, 256, size=500_000).astype(np.uint8))
    comp = native.bgzf_compress_native(payload)
    assert comp.endswith(bl.BGZF_EOF)
    p = str(tmp_path / "b.bgzf")
    with open(p, "wb") as fh:
        fh.write(comp)
    assert bl.bgzf_decompress(p) == payload
    # and the C++ decoder reads its own framing back via bam path is not
    # applicable (not a BAM); pure-python decompress above is the check.


def test_native_bam_empty_records(tmp_path):
    from falcon_unzip_tpu.io import bamlite as bl
    bam = bl.BamFile(text="@HD\tVN:1.6\n", refs=[("c0", 100)], records=[])
    path = str(tmp_path / "e.bam")
    bl.write_bam(path, bam)
    cols = native.read_bam_native(path)
    assert len(cols) == 0 and cols.refs == [("c0", 100)]
