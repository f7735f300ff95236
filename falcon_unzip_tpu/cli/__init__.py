"""Command-line layer (the fc_*.py console-script roles).

Role parity: [U] setup.py entry_points — ~15 fc_* tools (SURVEY.md §1
L4).  Re-design: ONE `falcon-unzip-tpu` entry with subcommands; each
subcommand mirrors a reference tool:

  unzip        <- fc_unzip.py          (3-unzip driver)
  quiver       <- fc_quiver.py         (4-polish driver)
  phase        <- fc_phasing.py        (per-contig het call + phasing)
  ovlp-filter  <- fc_ovlp_filter_with_phase.py
  graph        <- fc_phased_ovlp_to_graph.py + fc_graphs_to_h_tigs_2.py
  track        <- fc_rr_hctg_track.py / fc_get_read2ctg.py
  dedup        <- fc_dedup_h_tigs.py
  gen-gfa      <- fc_unzip_gen_gfa_v1.py
  bench        <- (new) kernel micro-bench
"""
from __future__ import annotations

import argparse
import logging
import sys


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="falcon-unzip-tpu",
        description="Phased diploid assembly engine "
                    "(FALCON_unzip capabilities, JAX/XLA compute with a "
                    "CUDA banded-alignment kernel on the GPU)")
    ap.add_argument("-v", "--verbose", action="store_true")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("unzip", help="run the 3-unzip pipeline")
    p.add_argument("config", help="config file (.json or fc_unzip.cfg INI)")

    p = sub.add_parser("quiver", help="run the 4-polish pipeline")
    p.add_argument("config")

    p = sub.add_parser("phase", help="phase one contig from aligned reads")
    p.add_argument("--preads", required=True)
    p.add_argument("--draft", required=True)
    p.add_argument("--ctg-id", type=int, default=0)
    p.add_argument("--out", default="phased_reads")

    p = sub.add_parser("ovlp-filter", help="phase-aware overlap filter")
    p.add_argument("--preads", required=True)
    p.add_argument("--phased-reads", required=True)
    p.add_argument("--out", default="filtered_overlaps.json")

    p = sub.add_parser("track", help="map reads onto contigs (read2ctg)")
    p.add_argument("--reads", required=True)
    p.add_argument("--contigs", required=True)
    p.add_argument("--out", default="read_to_contig_map.json")

    p = sub.add_parser("dedup", help="drop h_ctgs duplicating their primary")
    p.add_argument("--p-ctg", required=True)
    p.add_argument("--h-ctg", required=True)
    p.add_argument("--max-identity", type=float, default=0.99)
    p.add_argument("--out", default="h_ctg.dedup.fa")

    p = sub.add_parser("gen-gfa", help="emit GFA-1 of the unzipped assembly")
    p.add_argument("--unzip-dir", required=True)
    p.add_argument("--out", default="asm.gfa")

    p = sub.add_parser(
        "readmap", help="merge per-contig phased_reads -> rid_to_phase.all")
    p.add_argument("inputs", nargs="+", help="per-contig phased_reads files")
    p.add_argument("--out", default="rid_to_phase.all")

    p = sub.add_parser(
        "graph", help="phased overlaps -> string graph -> haplotigs")
    p.add_argument("--preads", required=True)
    p.add_argument("--phased-reads", required=True,
                   help="all_phased_reads / rid_to_phase.all file")
    p.add_argument("--overlaps", help="preads.ovl dump (default: recompute)")
    p.add_argument("--out-dir", default=".")

    p = sub.add_parser(
        "select-reads", help="partition a BAM into per-contig BAMs")
    p.add_argument("--bam", required=True)
    p.add_argument("--map", required=True,
                   help="JSON read->contig map (names or ids)")
    p.add_argument("--reads", help="FASTA giving names for integer read ids")
    p.add_argument("--out-pattern", default="ctg_{}.bam")

    p = sub.add_parser("bam2m4", help="BAM alignments -> m4 placement lines")
    p.add_argument("--bam", required=True)
    p.add_argument("--out", default="aln.m4")

    sub.add_parser("bench", help="run the kernel micro-benchmark")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ..utils.compile_cache import enable as enable_compile_cache
    enable_compile_cache()
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    if args.cmd == "unzip":
        from ..config import load_config
        from ..pipeline.unzip import run_unzip
        print(run_unzip(load_config(args.config)))
    elif args.cmd == "quiver":
        from ..config import load_config
        from ..pipeline.quiver import run_quiver
        print(run_quiver(load_config(args.config)))
    elif args.cmd == "phase":
        _cmd_phase(args)
    elif args.cmd == "ovlp-filter":
        _cmd_ovlp_filter(args)
    elif args.cmd == "track":
        _cmd_track(args)
    elif args.cmd == "dedup":
        _cmd_dedup(args)
    elif args.cmd == "gen-gfa":
        _cmd_gen_gfa(args)
    elif args.cmd == "readmap":
        _cmd_readmap(args)
    elif args.cmd == "graph":
        _cmd_graph(args)
    elif args.cmd == "select-reads":
        _cmd_select_reads(args)
    elif args.cmd == "bam2m4":
        _cmd_bam2m4(args)
    elif args.cmd == "bench":
        import subprocess
        import os
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        return subprocess.call([sys.executable,
                                os.path.join(root, "bench.py")])
    return 0


def _cmd_phase(args):
    from ..io.fasta import read_fasta
    from ..models.aligner import ReadToContigAligner
    from ..models.phaser import phase_contig_device, phased_reads_table
    preads = read_fasta(args.preads)
    draft = read_fasta(args.draft)
    al = ReadToContigAligner([draft.row(i) for i in range(len(draft))])
    aln = al.align_batch(preads)
    ph = phase_contig_device(aln, args.ctg_id, int(draft.lengths[args.ctg_id]))
    with open(args.out, "w") as fh:
        for rid, ctg, blk, phs in phased_reads_table(ph):
            if blk >= 0:
                name = preads.names[rid] if preads.names else f"read/{rid}"
                fh.write(f"{int(ctg):06d}F {int(blk)} {int(phs)} {name}\n")
    print(f"phased {int((ph.r_block >= 0).sum())}/{len(ph.read_ids)} reads, "
          f"{len(ph.het_pos)} het sites -> {args.out}")


def _cmd_ovlp_filter(args):
    import numpy as np
    from ..io.fasta import read_fasta
    from ..io.serialize import serialize
    from ..models.overlapper import PreadOverlapper
    from ..models.unzipper import phase_filter_mask
    preads = read_fasta(args.preads)
    name_to_id = {n: i for i, n in enumerate(preads.names or [])}
    n = len(preads)
    read_ctg = np.full(n, -1, np.int64)
    read_block = np.full(n, -1, np.int64)
    read_phase = np.full(n, -1, np.int8)
    with open(args.phased_reads) as fh:
        for line in fh:
            ctg, blk, phs, name = line.split()
            rid = name_to_id.get(name)
            if rid is not None:
                read_ctg[rid] = int(ctg.rstrip("F"), 10)
                read_block[rid] = int(blk)
                read_phase[rid] = int(phs)
    ovl = PreadOverlapper(preads).compute()
    keep = phase_filter_mask(ovl, read_ctg, read_block, read_phase)
    serialize(args.out, {
        "kept": [[int(ovl.a_id[o]), int(ovl.b_id[o]), int(ovl.strand[o]),
                  int(ovl.a_start[o]), int(ovl.a_end[o]),
                  int(ovl.b_start[o]), int(ovl.b_end[o])]
                 for o in range(len(ovl)) if keep[o]]})
    print(f"kept {int(keep.sum())}/{len(ovl)} overlaps -> {args.out}")


def _cmd_track(args):
    from ..io.fasta import read_fasta
    from ..io.serialize import serialize
    from ..models.aligner import ReadToContigAligner
    reads = read_fasta(args.reads)
    ctgs = read_fasta(args.contigs)
    al = ReadToContigAligner([ctgs.row(i) for i in range(len(ctgs))])
    aln = al.align_batch(reads)
    r2c = {int(aln.read_id[a]): [int(aln.ctg[a]), int(aln.t_start[a]),
                                 int(aln.t_end[a]), int(aln.strand[a])]
           for a in range(len(aln))}
    serialize(args.out, r2c)
    print(f"tracked {len(r2c)}/{len(reads)} reads -> {args.out}")


def _cmd_dedup(args):
    from ..io.fasta import read_fasta, write_fasta
    from ..models.dedup import dedup_haplotigs
    p = read_fasta(args.p_ctg)
    h = read_fasta(args.h_ctg)
    kept = dedup_haplotigs(p, h, max_identity=args.max_identity)
    write_fasta(args.out, ((h.names[i], h.to_str(i)) for i in kept))
    print(f"kept {len(kept)}/{len(h)} haplotigs -> {args.out}")


def _cmd_gen_gfa(args):
    import os
    from ..io.fasta import read_fasta
    from ..io.gfa import write_gfa
    from ..io.serialize import deserialize
    from ..models.unzipper import Haplotig
    p = read_fasta(os.path.join(args.unzip_dir, "all_p_ctg.fa"))
    h = read_fasta(os.path.join(args.unzip_dir, "all_h_ctg.fa"))
    try:
        plc = {x["h"]: x for x in deserialize(
            os.path.join(args.unzip_dir, "h_ctg_placements.json"))}
    except FileNotFoundError:
        plc = {}
    p_ctg = [(p.names[i], p.row(i), []) for i in range(len(p))]
    h_ctg = []
    for i in range(len(h)):
        info = plc.get(h.names[i], {})
        h_ctg.append(Haplotig(
            name=h.names[i], seq=h.row(i),
            primary=info.get("p", h.names[i].rsplit("_", 1)[0]),
            p_start=info.get("start", 0), p_end=info.get("end", 0),
            reads=[], phase=info.get("phase", -1)))
    write_gfa(args.out, p_ctg, h_ctg)
    print(f"wrote {args.out}")


def _cmd_readmap(args):
    """fc_phasing_readmap role: merge per-contig phased_reads files."""
    seen = set()
    n = 0
    with open(args.out, "w") as out:
        for path in args.inputs:
            with open(path) as fh:
                for line in fh:
                    if line.strip() and line not in seen:
                        seen.add(line)
                        out.write(line)
                        n += 1
    print(f"merged {n} phased-read rows from {len(args.inputs)} files "
          f"-> {args.out}")


def _parse_phased_reads(path, name_to_id, n):
    import numpy as np
    read_ctg = np.full(n, -1, np.int64)
    read_block = np.full(n, -1, np.int64)
    read_phase = np.full(n, -1, np.int8)
    with open(path) as fh:
        for line in fh:
            ctg, blk, phs, name = line.split()
            rid = name_to_id.get(name)
            if rid is not None:
                read_ctg[rid] = int(ctg.rstrip("F"), 10)
                read_block[rid] = int(blk)
                read_phase[rid] = int(phs)
    return read_ctg, read_block, read_phase


def _cmd_graph(args):
    """fc_phased_ovlp_to_graph + fc_graphs_to_h_tigs_2 roles."""
    import os
    from ..io.fasta import read_fasta, write_fasta
    from ..models.overlapper import PreadOverlapper
    from ..models.unzipper import Unzipper, phase_filter_mask
    from ..seq import decode
    preads = read_fasta(args.preads)
    name_to_id = {nm: i for i, nm in enumerate(preads.names or [])}
    read_ctg, read_block, read_phase = _parse_phased_reads(
        args.phased_reads, name_to_id, len(preads))
    if args.overlaps:
        from ..io.overlaps import read_overlaps
        ovl = read_overlaps(args.overlaps, name_to_id=name_to_id)
    else:
        ovl = PreadOverlapper(preads).compute()
    keep = phase_filter_mask(ovl, read_ctg, read_block, read_phase)
    uz = Unzipper(preads, read_block, read_phase, read_ctg=read_ctg)
    res = uz.unzip(ovl, keep)
    os.makedirs(args.out_dir, exist_ok=True)
    if res.graph is not None:
        res.graph.write_sg_edges(os.path.join(args.out_dir, "sg_edges_list"),
                                 names=preads.names)
    write_fasta(os.path.join(args.out_dir, "all_p_ctg.fa"),
                ((nm, decode(sq)) for nm, sq, _ in res.p_ctg))
    write_fasta(os.path.join(args.out_dir, "all_h_ctg.fa"),
                ((h.name, decode(h.seq)) for h in res.h_ctg))
    print(f"{len(res.p_ctg)} primary + {len(res.h_ctg)} haplotigs "
          f"-> {args.out_dir}")


def _cmd_select_reads(args):
    """fc_select_reads_from_bam role: BAM -> per-contig BAMs."""
    from ..io.bamlite import select_reads_by_contig
    from ..io.serialize import deserialize
    raw = deserialize(args.map)
    r2c = {}
    names = None
    if args.reads:
        from ..io.fasta import read_fasta
        names = read_fasta(args.reads).names
    for k, v in raw.items():
        ctg = int(v[0]) if isinstance(v, (list, tuple)) else int(v)
        if isinstance(k, str) and not k.isdigit():
            r2c[k] = ctg
        elif names:
            r2c[names[int(k)]] = ctg
    n_ctg = max(r2c.values(), default=-1) + 1
    outs = select_reads_by_contig(args.bam, r2c, args.out_pattern, n_ctg)
    print(f"wrote {len(outs)} per-contig BAMs ({args.out_pattern})")


def _cmd_bam2m4(args):
    """proto/sam2m4 role: BAM -> m4 placement records."""
    from ..coords import sam_to_m4, write_m4
    from ..io import native
    from ..io.bamlite import read_bam
    bam = native.read_bam_native(args.bam).to_bamfile() \
        if native.available() else read_bam(args.bam)
    recs = [m for m in (sam_to_m4(r, bam.refs) for r in bam.records)
            if m is not None]
    write_m4(args.out, recs)
    print(f"{len(recs)} m4 records -> {args.out}")


if __name__ == "__main__":
    sys.exit(main())
