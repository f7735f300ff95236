"""3-unzip pipeline driver (the fc_unzip.py role).

Role parity: [U] falcon_unzip/unzip.py::run + tasks/unzip.py — the
pypeFLOW DAG of track-reads → per-contig phasing → hasm (phase-filtered
graph) → haplotig extraction → gather (SURVEY.md §3.1).  Re-design: the
same stage boundaries and durable artifacts, but stages are in-process
device programs (no bash scripts, no scheduler); resume = Stage markers
(Makefile semantics parity, SURVEY.md §5).

Outputs (under <out>/3-unzip/):
  all_p_ctg.fa, all_h_ctg.fa         — primary contigs + haplotigs
  all_h_ctg_ids                      — haplotig id list
  all_phased_reads                   — per-read (ctg, block, phase)
  h_ctg_placements.json              — haplotig placements on primaries
  read_to_contig_map.json         — read tracking (rr_hctg_track role)
"""
from __future__ import annotations

import logging
import os

import numpy as np

from ..config import PipelineConfig
from ..io.fasta import read_fasta, write_fasta
from ..io.serialize import serialize
from ..models.aligner import AlignerConfig, ReadToContigAligner
from ..models.overlapper import OverlapperConfig, PreadOverlapper
from ..models.phaser import phase_contig_device, phased_reads_table
from ..models.unzipper import (OvlpFilterConfig, UnzipConfig, Unzipper,
                               phase_filter_mask)
from ..oracle.phasing import PhasingConfig
from ..parallel.checkpoint import Stage
from ..seq import decode
from ..utils.metrics import MetricsLog, assembly_stats, phase_block_stats

logger = logging.getLogger(__name__)


def run_unzip(cfg: PipelineConfig) -> dict:
    if cfg.profile_dir:  # jax.profiler device trace around the whole run
        from ..utils.profiling import device_trace
        with device_trace(cfg.profile_dir):
            return _run_unzip(cfg)
    return _run_unzip(cfg)


def _run_unzip(cfg: PipelineConfig) -> dict:
    cfg.validate()
    # ---- multi-host: one process per host joins the jax.distributed
    # world; host compute is replicated, the EXPENSIVE work (alignment,
    # overlap candidates, sharded device steps) is host/device-sharded,
    # and only host 0 writes the canonical artifacts (SURVEY.md §2c)
    from ..parallel import distributed as dist
    if cfg.mesh.debug_sharding:
        from ..parallel import debug
        debug.enable(True)
    if cfg.mesh.multihost:
        dist.initialize()
    multi = dist.process_count() > 1
    out_root = cfg.out_dir
    if multi and not dist.is_primary_host():
        import jax
        out_root = os.path.join(cfg.out_dir, f".host{jax.process_index()}")
    sync = dist.sync_stage_done if multi else None
    out = os.path.join(out_root, "3-unzip")
    os.makedirs(out, exist_ok=True)
    metrics = MetricsLog(os.path.join(out_root, "metrics.jsonl"))

    preads = read_fasta(cfg.preads)
    logger.info("loaded %d preads", len(preads))

    # ---- stage 0: draft contigs (given, or de novo from the pread graph)
    draft_stage = Stage(out, "0-draft", inputs=[cfg.preads, cfg.draft],
                        outputs=["draft_p_ctg.fa"], resume=cfg.resume,
                        sync=sync)

    overlaps_holder: dict = {}

    def _compute_overlaps(primary_only: bool = False):
        """Host-sharded overlap compute.

        primary_only (the hasm path): the merged OverlapSet is retained
        on host 0 only — the string graph is host-0 work in the
        contig-owner dataflow, so other hosts keep O(shard) memory and
        return None.  Collective: every host must call."""
        if "ovl" not in overlaps_holder:
            ov_cfg = OverlapperConfig(
                k=cfg.overlap.k, band=cfg.overlap.band,
                min_overlap=cfg.overlap.min_overlap,
                min_identity=cfg.overlap.min_identity,
                end_fuzz=cfg.overlap.end_fuzz)
            overlapper = PreadOverlapper(preads, ov_cfg)
            if multi:
                # each host seeds/verifies the candidates of its a-read
                # shard; the gathered union re-sorts to the identical
                # overlap stream (OverlapSet.sort_canonical)
                local = overlapper.compute(dist.host_shard(len(preads)))
                from ..models.overlapper import OverlapSet
                if primary_only:
                    got = dist.gather_to_primary(local.to_bytes())
                    overlaps_holder["ovl"] = OverlapSet.merge(
                        [OverlapSet.from_bytes(b) for b in got]) \
                        if got is not None else None
                else:
                    overlaps_holder["ovl"] = OverlapSet.merge(
                        [OverlapSet.from_bytes(b)
                         for b in dist.allgather_bytes(local.to_bytes())])
            else:
                overlaps_holder["ovl"] = overlapper.compute()
            overlaps_holder["timings"] = overlapper.timings
        return overlaps_holder["ovl"]

    def _draft(st: Stage):
        if cfg.draft:
            batch = read_fasta(cfg.draft)
            recs = [(batch.names[i], batch.to_str(i))
                    for i in range(len(batch))]
        else:
            # de novo: unphased string-graph walk over pread overlaps
            ovl = _compute_overlaps()
            uz = Unzipper(preads,
                          read_block=np.full(len(preads), -1, np.int64),
                          read_phase=np.full(len(preads), -1, np.int8),
                          cfg=UnzipConfig(fuzz=cfg.graph.fuzz,
                                          reduction_fuzz=cfg.graph.reduction_fuzz))
            keep = np.ones(len(ovl), bool)
            res = uz.unzip(ovl, keep)
            recs = [(nm, decode(sq)) for nm, sq, _ in res.p_ctg]
        write_fasta(st.out("draft_p_ctg.fa"), recs)
        return {"n_draft": len(recs)}

    draft_stage.run(_draft)
    draft = read_fasta(draft_stage.out("draft_p_ctg.fa"))
    contigs = [draft.row(i) for i in range(len(draft))]

    # ---- contig-owner partition (SURVEY.md §2c all_to_all row): each
    # host OWNS a length-balanced subset of contigs; post-alignment host
    # work (phasing, window prep) runs only on the owner, so host memory
    # and compute are O(genome / n_hosts) instead of O(genome)
    n_hosts = dist.process_count()
    owners = dist.contig_owners([len(c) for c in contigs], n_hosts)
    my_host = 0
    if multi:
        import jax
        my_host = jax.process_index()

    # ---- stage 1: track + align reads to draft (blasr/phasing prep role)
    # the alignment is computed lazily: a fully up-to-date resume reloads
    # everything downstream from stage outputs and never aligns
    _aln_cache: dict = {}

    def get_aln():
        """Owned-contig AlnSet: host-sharded alignment, records routed to
        each contig's owner host (multi); the full set on one host.

        Single-host runs PERSIST the AlnSet next to the 1-align stage
        (written by _track, loaded here when the stage is up to date):
        a partial resume — killed mid-phasing/hasm — used to re-pay the
        whole wall-clock-dominant re-alignment because only derived
        tracking columns were durable (measured: 3294 s re-align on the
        40 Mb config-5 restart)."""
        if "a" not in _aln_cache:
            import time as _time
            if not multi:
                blob = os.path.join(out, "1-align", "aln_set.npz")
                probe = Stage(
                    out, "1-align",
                    inputs=[cfg.preads,
                            draft_stage.out("draft_p_ctg.fa")],
                    outputs=["read_to_contig_map.json"],
                    resume=cfg.resume)
                if cfg.resume and probe.is_done() \
                        and os.path.exists(blob):
                    from ..models.aligner import AlnSet
                    _t0 = _time.perf_counter()
                    with open(blob, "rb") as fh:
                        _aln_cache["a"] = AlnSet.from_bytes(fh.read())
                    metrics.log("align_reload",
                                s=round(_time.perf_counter() - _t0, 2))
                    return _aln_cache["a"]
            _t0 = _time.perf_counter()
            aligner = ReadToContigAligner(contigs, AlignerConfig(
                k=cfg.align.k, band=cfg.align.band,
                window_pad=cfg.align.window_pad,
                min_identity=cfg.align.min_identity,
                batch_pairs=cfg.align.batch_pairs))
            if multi:
                # host-sharded alignment (the wall-clock dominant stage):
                # each host seeds + DP-verifies its read shard, then
                # routes each record to its contig's OWNER; the owner's
                # canonical merge is byte-identical to the records the
                # old full allgather held for those contigs
                from ..models.aligner import AlnSet
                local = aligner.align_batch(
                    preads, read_range=dist.host_shard(len(preads)))
                rec_owner = owners[local.ctg]
                blobs = [local.subset(rec_owner == d).to_bytes()
                         for d in range(n_hosts)]
                _aln_cache["a"] = AlnSet.merge(
                    [AlnSet.from_bytes(b)
                     for b in dist.exchange_to_owners(blobs)])
            else:
                _aln_cache["a"] = aligner.align_batch(preads)
            metrics.log("align_compute",
                        s=round(_time.perf_counter() - _t0, 2),
                        **aligner.timings)
        return _aln_cache["a"]

    def _gather_track_cols():
        """Global per-read placement columns from owner-sharded AlnSets
        (small arrays: O(reads), no tags)."""
        aln = get_aln()
        cols = {"rid": aln.read_id, "ctg": aln.ctg, "ts": aln.t_start,
                "te": aln.t_end, "st": aln.strand.astype(np.int32)}
        if not multi:
            return cols
        from ..parallel.distributed import pack_arrays, unpack_arrays
        parts = [unpack_arrays(b)
                 for b in dist.allgather_bytes(pack_arrays(cols))]
        merged = {k: np.concatenate([p[k] for p in parts])
                  for k in cols}
        order = np.argsort(merged["rid"], kind="stable")
        return {k: v[order] for k, v in merged.items()}

    # ---- overlap prefetch (dataflow engine, SURVEY.md §2c dataflow
    # row): the hasm overlap compute depends only on the preads, so in
    # single-host mode it runs CONCURRENTLY with stages 1-2 — the
    # overlap candidate chaining (host numpy) fills the gaps where the
    # driver waits on alignment/phasing device programs.  Multi-host
    # keeps it synchronous: the compute issues collectives, and two
    # collective streams must not interleave differently across hosts.
    phased_path = os.path.join(out, "all_phased_reads")
    # the probe must declare the SAME outputs as the real 3-hasm stage,
    # or it can report done while the real stage will rerun (and the
    # prefetch would be skipped) — ADVICE r3
    hasm_outputs = ["../all_p_ctg.fa", "../all_h_ctg.fa",
                    "../all_h_ctg_ids", "../h_ctg_placements.json",
                    "../h_ctg_placements.m4", "../preads.ovl"]
    hasm_probe = Stage(out, "3-hasm", inputs=[cfg.preads, phased_path],
                       outputs=hasm_outputs, resume=cfg.resume)
    phasing_probe = Stage(
        out, "2-phasing",
        inputs=[cfg.preads, draft_stage.out("draft_p_ctg.fa")],
        outputs=["../all_phased_reads"], resume=cfg.resume)
    ovl_prefetch = None
    if (not multi and cfg.overlap.prefetch
            and not (hasm_probe.is_done() and phasing_probe.is_done())):
        from ..parallel.dataflow import Prefetch
        ovl_prefetch = Prefetch("overlap-compute", _compute_overlaps)

    align_stage = Stage(out, "1-align",
                        inputs=[cfg.preads, draft_stage.out("draft_p_ctg.fa")],
                        outputs=["read_to_contig_map.json"],
                        resume=cfg.resume, sync=sync)

    def _track(st: Stage):
        cols = _gather_track_cols()
        r2c = {int(cols["rid"][a]): [int(cols["ctg"][a]),
                                     int(cols["ts"][a]),
                                     int(cols["te"][a]),
                                     int(cols["st"][a])]
               for a in range(len(cols["rid"]))}
        serialize(st.out("read_to_contig_map.json"), r2c)
        if not multi:
            # durable AlnSet: partial resumes reload instead of
            # re-aligning (see get_aln); written atomically so a kill
            # mid-write cannot leave a truncated blob that loads
            tmp = st.out("aln_set.npz.tmp")
            with open(tmp, "wb") as fh:
                fh.write(get_aln().to_bytes())
            os.replace(tmp, st.out("aln_set.npz"))
        metrics.log("align", n_aligned=len(r2c), n_reads=len(preads))
        return {"n_aligned": len(r2c)}

    align_stage.run(_track)

    # ---- stage 2: per-contig phasing (fc_phasing role), resumable
    n_reads = len(preads)
    read_ctg = np.full(n_reads, -1, np.int64)
    read_block = np.full(n_reads, -1, np.int64)
    read_phase = np.full(n_reads, -1, np.int8)
    phasing_stage = Stage(
        out, "2-phasing",
        inputs=[cfg.preads, draft_stage.out("draft_p_ctg.fa")],
        outputs=["../all_phased_reads"], resume=cfg.resume, sync=sync)

    def _phase(st: Stage):
        ph_cfg = PhasingConfig(
            min_depth=cfg.phase.min_depth,
            min_allele_count=cfg.phase.min_allele_count,
            allele_freq_min=cfg.phase.allele_freq_min,
            biallelic_frac=cfg.phase.biallelic_frac,
            max_span=cfg.phase.max_span, min_link=cfg.phase.min_link)
        from ..parallel.sharding import ShardedPhaseOps, make_pipeline_mesh
        # contig-owner dataflow: per-contig device programs never cross
        # hosts, so the mesh is local in multi-host mode
        mesh = make_pipeline_mesh(cfg.mesh.n_devices, cfg.mesh.window_par,
                                  local_only=multi)
        phase_ops = ShardedPhaseOps(mesh) if mesh is not None else None
        if mesh is not None:
            logger.info("phasing over mesh %s", dict(mesh.shape))
        import time as _time
        aln = get_aln()
        _t0 = _time.perf_counter()
        my_ctgs = (np.nonzero(owners == my_host)[0] if multi
                   else np.arange(len(contigs)))
        if phase_ops is None:
            # grouped batched device programs: a few dispatch/fetch
            # rounds for ALL contigs instead of ~6 round trips per
            # contig
            from ..models.phaser import phase_contigs_batched
            phs = phase_contigs_batched(
                aln, [int(c) for c in my_ctgs],
                [len(contigs[int(c)]) for c in my_ctgs], ph_cfg)
        else:
            phs = [phase_contig_device(aln, int(ci),
                                       len(contigs[int(ci)]), ph_cfg,
                                       phase_ops=phase_ops)
                   for ci in my_ctgs]
        metrics.log("phasing_total",
                    s=round(_time.perf_counter() - _t0, 2),
                    n_ctgs=len(my_ctgs))
        phase_rows = []
        for ci, ph in zip(my_ctgs, phs):
            phase_rows.append(phased_reads_table(ph))
            metrics.log("phasing", ctg=int(ci), n_het=len(ph.het_pos),
                        **phase_block_stats(ph.block_id, ph.het_pos))
        phased = np.concatenate(phase_rows) if phase_rows else \
            np.zeros((0, 4), np.int64)
        if multi:
            # gather the (small) per-contig tables from every owner and
            # restore ascending-contig order (stable, so within-contig
            # row order is each owner's deterministic table order)
            from ..parallel.distributed import pack_arrays, unpack_arrays
            parts = [unpack_arrays(b)["t"] for b in
                     dist.allgather_bytes(pack_arrays({"t": phased}))]
            phased = np.concatenate(parts)
            phased = phased[np.argsort(phased[:, 1], kind="stable")]
        # first-contig-wins read assignment, identical to the sequential
        # per-contig loop (a read maps to one contig; keep the first)
        for rid, ctg, blk, phs in phased:
            rid = int(rid)
            if read_ctg[rid] < 0:
                read_ctg[rid] = int(ctg)
                read_block[rid] = int(blk)
                read_phase[rid] = int(phs)
        with open(phased_path, "w") as fh:
            for rid, ctg, blk, phs in phased:
                if blk >= 0:
                    fh.write(f"{int(ctg):06d}F {int(blk)} {int(phs)} "
                             f"{_read_name(preads, int(rid))}\n")
        return {"n_phased": int((read_block >= 0).sum())}

    if not phasing_stage.run(_phase):
        # resume: rebuild the per-read phase arrays from the stage output
        name_to_id = {_read_name(preads, r): r for r in range(n_reads)}
        with open(phased_path) as fh:
            for line in fh:
                ctg_s, blk, phs, name = line.split()
                rid = name_to_id.get(name)
                if rid is not None:
                    read_ctg[rid] = int(ctg_s.rstrip("F"), 10)
                    read_block[rid] = int(blk)
                    read_phase[rid] = int(phs)

    # ---- stage 3: hasm — phase-filtered overlaps + graph + haplotigs
    hasm_stage = Stage(
        out, "3-hasm", inputs=[cfg.preads, phased_path],
        outputs=hasm_outputs, resume=cfg.resume, sync=sync)

    def _hasm(st: Stage):
        # graph construction + haplotig extraction is HOST-0 work in the
        # contig-owner dataflow (the string graph is global); other hosts
        # participate in the collective overlap compute, keep nothing,
        # and wait at the driver barrier
        import time as _time
        _t0 = _time.perf_counter()
        if ovl_prefetch is not None:
            try:
                ovl_prefetch.get()      # join the dataflow handle
            except Exception as exc:    # fall back to inline compute
                logger.warning("overlap prefetch failed (%s); "
                               "recomputing inline", exc)
                overlaps_holder.pop("ovl", None)
        ovl = _compute_overlaps(primary_only=True)
        metrics.log("hasm_overlaps", s=round(_time.perf_counter() - _t0, 2),
                    **overlaps_holder.get("timings", {}))
        if multi and not dist.is_primary_host():
            return {}
        keep = phase_filter_mask(ovl, read_ctg, read_block, read_phase,
                                 OvlpFilterConfig(
                                     min_overlap=cfg.overlap.min_overlap,
                                     min_identity=cfg.overlap.min_identity,
                                     fuzz=cfg.overlap.end_fuzz,
                                     max_diff=cfg.overlap.max_diff,
                                     max_cov=cfg.overlap.max_cov,
                                     min_cov=cfg.overlap.min_cov,
                                     bestn=cfg.overlap.bestn))
        metrics.log("ovlp_filter", n_overlaps=len(ovl),
                    n_kept=int(keep.sum()))

        # read placements come from the stage-1 track output, so a warm
        # hasm re-run does not need the aligner
        from ..io.serialize import deserialize
        r2c = deserialize(align_stage.out("read_to_contig_map.json"))
        t_start = np.full(n_reads, -1, np.int64)
        t_end = np.full(n_reads, -1, np.int64)
        p_ctg_of = np.full(n_reads, -1, np.int64)
        p_strand = np.zeros(n_reads, np.int8)
        for rid, rec in r2c.items():
            p_ctg_of[int(rid)] = int(rec[0])
            t_start[int(rid)] = int(rec[1])
            t_end[int(rid)] = int(rec[2])
            p_strand[int(rid)] = int(rec[3]) if len(rec) > 3 else 0

        uz = Unzipper(preads, read_block, read_phase, read_ctg=read_ctg,
                      placements=(t_start, t_end),
                      placement_ctg=p_ctg_of,
                      placement_strand=p_strand,
                      draft_seqs=contigs,
                      cfg=UnzipConfig(
                          fuzz=cfg.graph.fuzz,
                          reduction_fuzz=cfg.graph.reduction_fuzz,
                          max_bubble_steps=cfg.graph.max_bubble_steps))
        _t0 = _time.perf_counter()
        res = uz.unzip(ovl, keep)
        metrics.log("hasm_graph_walk",
                    s=round(_time.perf_counter() - _t0, 2),
                    n_rescues=uz.n_rescues, n_fills=uz.n_fills)

        # ---- optional haplotig dedup (fc_dedup_h_tigs role)
        _t0 = _time.perf_counter()
        if cfg.graph.dedup and res.h_ctg:
            from ..models.dedup import dedup_haplotigs
            from ..seq import SeqBatch
            p_b = SeqBatch.from_strs([sq for _, sq, _ in res.p_ctg])
            h_b = SeqBatch.from_strs([h.seq for h in res.h_ctg])
            kept = set(dedup_haplotigs(
                p_b, h_b, max_identity=cfg.graph.dedup_max_identity))
            dropped = len(res.h_ctg) - len(kept)
            res.h_ctg = [h for i, h in enumerate(res.h_ctg) if i in kept]
            metrics.log("dedup", n_dropped=dropped, n_kept=len(res.h_ctg))

        metrics.log("hasm_dedup", s=round(_time.perf_counter() - _t0, 2))

        # ---- haplotig placement by re-alignment (SURVEY.md §3.3 step 3)
        from ..coords import write_m4
        from ..models.unzipper import place_haplotigs
        _t0 = _time.perf_counter()
        m4 = place_haplotigs(res.p_ctg, res.h_ctg,
                             band=max(512, cfg.align.band))
        write_m4(os.path.join(out, "h_ctg_placements.m4"), m4)
        metrics.log("hasm_placement", s=round(_time.perf_counter() - _t0, 2))

        # ---- graph + overlap intermediates
        # (sg_edges_list / utg_data / ctg_paths / sg.gfa / LA dump)
        if res.graph is not None:
            res.graph.write_sg_edges(os.path.join(out, "sg_edges_list"),
                                     names=preads.names)
            res.graph.write_utg_data(os.path.join(out, "utg_data"),
                                     names=preads.names)
            from ..io.gfa import write_ctg_paths, write_sg_gfa
            write_ctg_paths(os.path.join(out, "ctg_paths"), res.p_ctg,
                            res.p_paths, res.graph, names=preads.names)
            write_sg_gfa(os.path.join(out, "sg.gfa"), res.graph,
                         preads.lengths, names=preads.names)
        from ..io.overlaps import write_overlaps
        write_overlaps(os.path.join(out, "preads.ovl"), ovl,
                       names=preads.names)

        # ---- gather outputs
        write_fasta(os.path.join(out, "all_p_ctg.fa"),
                    ((nm, decode(sq)) for nm, sq, _ in res.p_ctg))
        write_fasta(os.path.join(out, "all_h_ctg.fa"),
                    ((h.name, decode(h.seq)) for h in res.h_ctg))
        with open(os.path.join(out, "all_h_ctg_ids"), "w") as fh:
            for h in res.h_ctg:
                fh.write(h.name + "\n")
        serialize(os.path.join(out, "h_ctg_placements.json"),
                  [{"h": h.name, "p": h.primary, "start": h.p_start,
                    "end": h.p_end, "phase": int(h.phase),
                    "n_reads": len(h.reads)} for h in res.h_ctg])

        p_stats = assembly_stats([sq for _, sq, _ in res.p_ctg])
        h_stats = assembly_stats([h.seq for h in res.h_ctg])
        metrics.log("unzip", p=p_stats, h=h_stats)
        return {"p_ctg": p_stats, "h_ctg": h_stats}

    hasm_stage.run(_hasm)
    stats = hasm_stage.metrics()
    logger.info("unzip done: %s primary, %s haplotigs",
                stats.get("p_ctg"), stats.get("h_ctg"))
    if multi:   # canonical artifacts complete before any host reads them
        dist.barrier("unzip-done")
    return {**stats, "out_dir": out}


def _read_name(batch, rid: int) -> str:
    if batch.names:
        return batch.names[rid]
    return f"read/{rid}"

