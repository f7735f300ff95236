"""4-polish pipeline driver (the fc_quiver.py role).

Role parity: [U] tasks/quiver.py DAG — rr_hctg_track read tracking, BAM
partition by contig, per-contig blasr + Arrow, cns merge (SURVEY.md
§3.4).  Re-design: raw reads are aligned in-process to the combined
p_ctg + h_ctg reference, partitioned by columnar masks (no BAM shuffle),
and each contig is polished with the windowed vote + pair-HMM stage.

Outputs (under <out>/4-polish/):
  cns_p_ctg.fasta / cns_p_ctg.fastq
  cns_h_ctg.fasta / cns_h_ctg.fastq
  read_to_contig_map.json
"""
from __future__ import annotations

import logging
import os

import numpy as np

from ..config import PipelineConfig
from ..io.fasta import read_fasta, write_fasta, write_fastq
from ..io.serialize import serialize
from ..models.aligner import AlignerConfig, ReadToContigAligner
from ..models.polisher import Polisher, PolisherConfig, PolishedContig
from ..parallel.checkpoint import Stage
from ..seq import decode
from ..utils.metrics import MetricsLog, assembly_stats

logger = logging.getLogger(__name__)


def run_quiver(cfg: PipelineConfig) -> dict:
    if cfg.profile_dir:  # jax.profiler device trace around the whole run
        from ..utils.profiling import device_trace
        with device_trace(cfg.profile_dir):
            return _run_quiver(cfg)
    return _run_quiver(cfg)


def _run_quiver(cfg: PipelineConfig) -> dict:
    # ---- multi-host (see pipeline.unzip): canonical 3-unzip inputs are
    # always read from host 0's out_dir; non-primary hosts write scratch
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
    unzip_dir = os.path.join(cfg.out_dir, "3-unzip")
    out = os.path.join(out_root, "4-polish")
    os.makedirs(out, exist_ok=True)
    metrics = MetricsLog(os.path.join(out_root, "metrics.jsonl"))

    p_path = os.path.join(unzip_dir, "all_p_ctg.fa")
    h_path = os.path.join(unzip_dir, "all_h_ctg.fa")
    if not os.path.exists(p_path):
        raise FileNotFoundError(f"run the unzip stage first: {p_path}")
    p_batch = read_fasta(p_path)
    h_batch = read_fasta(h_path) if os.path.exists(h_path) else None

    names = list(p_batch.names or [])
    contigs = [p_batch.row(i) for i in range(len(p_batch))]
    n_primary = len(contigs)
    if h_batch is not None and len(h_batch):
        names += list(h_batch.names or [])
        contigs += [h_batch.row(i) for i in range(len(h_batch))]

    reads_path = cfg.reads or cfg.preads
    from ..io.ingest import read_seqs
    reads = read_seqs(reads_path)   # FASTA/FASTQ/BAM or .fofn of them
    logger.info("polish: %d reads vs %d contigs", len(reads), len(contigs))

    # ---- contig-owner partition over p_ctg + h_ctg (SURVEY.md §2c
    # all_to_all row): the owner host window-preps and polishes only its
    # contigs; host memory/compute are O(genome / n_hosts)
    n_hosts = dist.process_count()
    owners = dist.contig_owners([len(c) for c in contigs], n_hosts)
    my_host = 0
    if multi:
        import jax
        my_host = jax.process_index()

    # reads are aligned once, lazily — if every stage below is up to date
    # on resume, the (expensive) alignment never runs
    _aln = {}

    def get_aln():
        """Owned-contig AlnSet (multi: records routed to contig owners).

        Single-host runs persist the AlnSet next to 1-track (written by
        _track, reloaded here while the stage is up to date) so a kill
        mid-polish resumes without re-paying the raw-read alignment —
        see pipeline.unzip.get_aln."""
        if "a" not in _aln:
            import time as _time
            if not multi:
                blob = os.path.join(out, "1-track", "aln_set.npz")
                probe = Stage(out, "1-track",
                              inputs=[reads_path, p_path, h_path],
                              outputs=["read_to_contig_map.json"],
                              resume=cfg.resume)
                if cfg.resume and probe.is_done() \
                        and os.path.exists(blob):
                    from ..models.aligner import AlnSet
                    _t0 = _time.perf_counter()
                    with open(blob, "rb") as fh:
                        _aln["a"] = AlnSet.from_bytes(fh.read())
                    metrics.log("align_reload",
                                s=round(_time.perf_counter() - _t0, 2))
                    return _aln["a"]
            _t0 = _time.perf_counter()
            aligner = ReadToContigAligner(contigs, AlignerConfig(
                k=cfg.align.k, band=cfg.align.band,
                window_pad=cfg.align.window_pad,
                min_identity=cfg.align.min_identity,
                batch_pairs=cfg.align.batch_pairs))
            if multi:
                # host-sharded raw-read alignment, then owner routing
                # (see pipeline.unzip.get_aln)
                from ..models.aligner import AlnSet
                local = aligner.align_batch(
                    reads, read_range=dist.host_shard(len(reads)))
                rec_owner = owners[local.ctg]
                blobs = [local.subset(rec_owner == d).to_bytes()
                         for d in range(n_hosts)]
                _aln["a"] = AlnSet.merge(
                    [AlnSet.from_bytes(b)
                     for b in dist.exchange_to_owners(blobs)])
            else:
                _aln["a"] = aligner.align_batch(reads)
            metrics.log("align_compute",
                        s=round(_time.perf_counter() - _t0, 2),
                        **aligner.timings)
        return _aln["a"]

    # ---- stage 1: track reads -> combined reference (rr_hctg_track role)
    track_stage = Stage(out, "1-track", inputs=[reads_path, p_path, h_path],
                        outputs=["read_to_contig_map.json"],
                        resume=cfg.resume, sync=sync)

    def _track(st: Stage):
        aln = get_aln()
        rid, ctg = aln.read_id, aln.ctg
        if multi:
            from ..parallel.distributed import pack_arrays, unpack_arrays
            parts = [unpack_arrays(b) for b in dist.allgather_bytes(
                pack_arrays({"rid": rid, "ctg": ctg}))]
            rid = np.concatenate([p["rid"] for p in parts])
            ctg = np.concatenate([p["ctg"] for p in parts])
            order = np.argsort(rid, kind="stable")
            rid, ctg = rid[order], ctg[order]
        r2c = {int(rid[a]): int(ctg[a]) for a in range(len(rid))}
        serialize(st.out("read_to_contig_map.json"), r2c)
        if not multi:
            tmp = st.out("aln_set.npz.tmp")
            with open(tmp, "wb") as fh:
                fh.write(get_aln().to_bytes())
            os.replace(tmp, st.out("aln_set.npz"))
        return {"n_aligned": len(r2c)}

    track_stage.run(_track)

    # ---- stage 2: windowed polish (variantCaller/arrow role), resumable
    polish_stage = Stage(
        out, "2-polish", inputs=[reads_path, p_path, h_path],
        outputs=["../cns_p_ctg.fasta", "../cns_p_ctg.fastq",
                 "../cns_h_ctg.fasta", "../cns_h_ctg.fastq"],
        resume=cfg.resume, sync=sync)

    def _polish(st: Stage):
        from ..parallel.sharding import (ShardedArrowSplicer,
                                         ShardedWindowVotes,
                                         make_pipeline_mesh)
        pcfg = PolisherConfig(
            window=cfg.polish.window, overlap=cfg.polish.overlap,
            min_cov=cfg.polish.min_cov,
            del_min_cov=cfg.polish.del_min_cov,
            arrow_rounds=cfg.polish.arrow_rounds,
            arrow_candidates=cfg.polish.arrow_candidates,
            arrow_min_cov=cfg.polish.arrow_min_cov,
            margin_frac=cfg.polish.margin_frac,
            het_skip_frac=cfg.polish.het_skip_frac,
            hmm_band=cfg.polish.hmm_band,
            score_batch=cfg.polish.score_batch,
            splice_chunk=cfg.polish.splice_chunk)
        read_pvecs = None
        read_qtiers = None
        tier_tab = None
        if cfg.polish.qv_aware and getattr(reads, "base_qv", None) \
                is not None and any(len(t) for t in reads.base_qv):
            # PER-BASE tier conditioning (real Arrow's IQV/DQV role):
            # each read's phred track maps to tier ids; reads without a
            # track get tier 0 = global params
            from ..models.polisher import phred_to_tiers, tier_table
            read_qtiers = [
                phred_to_tiers(t) if len(t) else np.zeros(0, np.int8)
                for t in reads.base_qv]
            tier_tab = tier_table(pcfg.params)
            logger.info(
                "qv-aware polish: PER-BASE tiers for %d reads",
                sum(1 for t in read_qtiers if len(t)))
        elif cfg.polish.qv_aware and reads.mean_qv is not None:
            # base-quality tier: per-read params from the mean phred
            # track (reads without one, qv<=0, keep global params)
            from ..oracle.hmm import params_for_read_qv
            from ..ops.pairhmm import params_vector
            read_pvecs = np.stack(
                [params_vector(params_for_read_qv(float(q)))
                 for q in reads.mean_qv])
            logger.info("qv-aware polish: %d reads with quality tiers",
                        int((reads.mean_qv > 0).sum()))
        # contig-owner dataflow: device programs are per-host, mesh local
        mesh = make_pipeline_mesh(cfg.mesh.n_devices, cfg.mesh.window_par,
                                  local_only=multi)
        splicer = ShardedArrowSplicer(
            mesh, max_cand=pcfg.arrow_candidates,
            chunk=pcfg.splice_chunk, fixed_lq=pcfg.len_cap(),
            fixed_lj=pcfg.len_cap(),
            tier_params=tier_tab) if mesh is not None else None
        vote_ops = ShardedWindowVotes(mesh) \
            if mesh is not None and mesh.shape["window"] > 1 else None
        if mesh is not None:
            logger.info("polish scoring over mesh %s", dict(mesh.shape))
        polisher = Polisher(pcfg, splicer=splicer, vote_ops=vote_ops,
                            read_pvecs=read_pvecs,
                            read_qtiers=read_qtiers)
        my = (np.nonzero(owners == my_host)[0] if multi
              else np.arange(len(contigs)))
        import time as _time
        aln = get_aln()
        seg_excl = None
        if cfg.polish.phase_aware:
            # phase-aware read routing (the [U] rr_hctg_track role done
            # at the pileup level): primaries are pseudo-haplotypes, so
            # where no haplotig exists both haplotypes' reads map onto
            # the primary and split the het-site votes ~50/50 — Arrow
            # then picks per-column winners inconsistently (measured:
            # nearly all residual 1 Mb consensus errors were clustered
            # het-site substitutions).  Phasing the RAW reads against
            # each owned primary and dropping the phase group that
            # disagrees with the template's own alleles makes each
            # phase block polish to ONE consistent haplotype.
            _t0 = _time.perf_counter()
            from ..models.phaser import template_route_votes
            from ..oracle.phasing import PhasingConfig
            ph_cfg = PhasingConfig(
                min_depth=cfg.phase.min_depth,
                min_allele_count=cfg.phase.min_allele_count,
                allele_freq_min=cfg.phase.allele_freq_min,
                biallelic_frac=cfg.phase.biallelic_frac,
                max_span=cfg.phase.max_span, min_link=cfg.phase.min_link)
            prim = [int(i) for i in my if int(i) < n_primary]
            routed = template_route_votes(
                aln, prim, [len(contigs[i]) for i in prim],
                [contigs[i] for i in prim], ph_cfg)
            # opposite-phase records are MASKED, not dropped: their
            # votes at het columns (and +-1 neighbors) are stripped and
            # they sit out Arrow segment scoring, but they still vote
            # everywhere else.  Whole-read dropping halved coverage
            # across entire het-span regions, and scripts/qv_attrib.py
            # showed the residual interior errors clustering in het
            # spans but NOT at het sites — i.e. plain low-coverage
            # consensus errors, not phasing errors.
            # Mask on a shallow copy: the cached AlnSet from get_aln()
            # is shared; in-place tag stripping would leak the one-shot
            # routing into any later consumer (ADVICE r4).  Replaced
            # entries are fresh arrays, so copying the list suffices.
            import dataclasses as _dc
            aln = _dc.replace(aln, tags=list(aln.tags))
            seg_excl = np.zeros(len(aln), bool)
            n_drop = 0
            for rec_idx, votes, het in routed:
                bad = rec_idx[votes < 0]
                n_drop += len(bad)
                seg_excl[bad] = True
                if not len(het) or not len(bad):
                    continue
                hs = np.sort(np.asarray(het))
                for a in bad:
                    t = aln.tags[a]
                    if t is None or not len(t):
                        continue
                    j = np.searchsorted(hs, t[:, 0])
                    near = (np.abs(hs[np.clip(j, 0, len(hs) - 1)]
                                   - t[:, 0]) <= 1)
                    near |= (np.abs(hs[np.clip(j - 1, 0, len(hs) - 1)]
                                    - t[:, 0]) <= 1)
                    aln.tags[a] = t[~near]
            metrics.log("polish_phase_route", n_dropped=n_drop,
                        s=round(_time.perf_counter() - _t0, 2))
        _t0 = _time.perf_counter()
        local_polished = polisher.polish_all(
            [(names[int(i)], contigs[int(i)]) for i in my], aln,
            ids=[int(i) for i in my], seg_exclude=seg_excl)
        metrics.log("polish_windows",
                    s=round(_time.perf_counter() - _t0, 2))
        if multi:
            # gather per-contig pieces to host 0 (canonical emitter)
            from ..parallel.distributed import pack_arrays, unpack_arrays
            cols = {"idx": np.asarray(my, np.int64)}
            for j, c in enumerate(local_polished):
                cols[f"s{j}"] = c.seq
                cols[f"q{j}"] = c.qv
            got = dist.gather_to_primary(pack_arrays(cols))
            if got is None:
                return {}
            by_idx = {}
            for blob in got:
                part = unpack_arrays(blob)
                for j, gi in enumerate(part["idx"]):
                    gi = int(gi)
                    by_idx[gi] = PolishedContig(
                        name=names[gi], seq=part[f"s{j}"],
                        qv=part[f"q{j}"])
            polished = [by_idx[i] for i in range(len(contigs))]
        else:
            polished = local_polished
        p_out = [c for i, c in enumerate(polished) if i < n_primary]
        h_out = [c for i, c in enumerate(polished) if i >= n_primary]
        _emit(out, "cns_p_ctg", p_out)
        _emit(out, "cns_h_ctg", h_out)
        return {
            "p": assembly_stats([c.seq for c in p_out]),
            "h": assembly_stats([c.seq for c in h_out]),
            "mean_qv": round(float(np.mean([c.qv.mean() for c in polished
                                            if len(c.qv)])), 2)
            if polished else 0.0,
        }

    polish_stage.run(_polish)
    stats = polish_stage.metrics()
    metrics.log("polish", **stats)
    logger.info("polish done: %s", stats)
    if multi:
        dist.barrier("quiver-done")
    return {**stats, "out_dir": out}


def _phase_route_mask(aln, ctg_ids: list[int], t_lens: list[int],
                      templates: list, cfg: PipelineConfig,
                      phase_ops=None) -> "np.ndarray":
    """Per-record keep mask dropping reads whose alleles OPPOSE the
    template's own haplotype at the het sites they span.

    Role parity: [U] fc_rr_hctg_track + fc_get_read_hctg_map partition
    raw reads by phase before quiver maps them ([U] SURVEY.md §3.4 step
    1).  The partition needs no association table or phase blocks: the
    polish template IS one haplotype per phase block, so a record is
    kept iff it agrees with the template's own allele at a majority of
    the het sites it covers (+1 template allele / -1 opposite allele
    per site, drop on a net-negative vote).  Batched het calling + one
    vote scatter across ALL contigs replaces the full per-contig
    re-phasing that was the 4th-largest wall-clock item at 10 Mb
    (VERDICT r3 weak #7).  Records spanning no usable het site keep.

    phase_ops is accepted for API compatibility and unused — the vote
    path has no collective component."""
    from ..models.phaser import template_route_votes
    from ..oracle.phasing import PhasingConfig
    keep = np.ones(len(aln), bool)
    ph_cfg = PhasingConfig(
        min_depth=cfg.phase.min_depth,
        min_allele_count=cfg.phase.min_allele_count,
        allele_freq_min=cfg.phase.allele_freq_min,
        biallelic_frac=cfg.phase.biallelic_frac,
        max_span=cfg.phase.max_span, min_link=cfg.phase.min_link)
    for rec_idx, votes, _het in template_route_votes(
            aln, ctg_ids, t_lens, templates, ph_cfg):
        keep[rec_idx[votes < 0]] = False
    return keep


def _emit(out_dir: str, stem: str, contigs) -> None:
    write_fasta(os.path.join(out_dir, f"{stem}.fasta"),
                ((c.name, decode(c.seq)) for c in contigs))
    write_fastq(os.path.join(out_dir, f"{stem}.fastq"),
                ((c.name, decode(c.seq),
                  "".join(chr(33 + int(q)) for q in c.qv))
                 for c in contigs))


