"""Multi-host distributed compression.

The reference is a single-process tool (SURVEY.md §2: no MPI/NCCL; its only
parallelism is a 2-thread split, xsqueezeit.cpp:120-148).  Here scale-out is
first-class: variant blocks are independent (the PBWT arrangement re-seeds
to identity at every block boundary), so

  * the input is partitioned into contiguous block ranges, one per worker
    (a host or card in a `jax.distributed` job, or a local emulated
    worker),
  * every worker encodes only its blocks (device codec on its local chips),
  * per-block compressed payloads gather to worker 0 IN ORIGINAL BLOCK
    ORDER, which assembles a container byte-identical to the single-host
    output (the north-star contract), while worker 0 also writes the
    variant BCF + CSI in its streaming pass.

Two drivers share the plan:

  * `compress_file_distributed` — N emulated workers in-process (threads);
    fast to test, validates partition/gather/assembly byte-identity.
  * `compress_file_multihost` — real separate processes under
    `jax.distributed` (launch one process per host with the same CLI
    arguments plus --distributed/--dist-nproc/--dist-procid, or call
    `init_distributed` yourself).  Process 0 writes the variant BCF + CSI
    during its streaming pass; every process encodes its contiguous block
    range; the per-block payload bytes ride `gather_blocks_to_host0`
    (three `multihost_utils.process_allgather` calls: counts, lengths,
    padded uint8 bytes — metadata first so every process pads to the same
    global shape) and process 0 assembles the container.  Output is
    byte-identical to the single-process `compress_file`.
"""
from __future__ import annotations

import os
import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..codec.compressor import (
    BlockEncodeDispatcher,
    CompressorOptions,
    _device_encoder_cls,
    make_variant_header,
)
from ..format.constants import (
    BM_BLOCK_BITS,
    XSI_BCF_VAR_EXTENSION,
)
from ..format.container import XsiWriter
from ..format.header import XsiHeader
from ..io.bcf import BcfWriter, patch_shared_sample_counts
from ..io.csi import CsiBuilder, depth_for_max_len
from ..io.sites import encode_bm_indiv
from ..io.unified import (
    GtInput,
    sniff_default_phased,
    sniff_max_ploidy_first_entry,
)


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     local_device_ids: list[int] | None = None
                     ) -> tuple[int, int]:
    """Initialize jax.distributed for a multi-process run; returns
    (process_index, process_count).  No-op single-process fallback.

    local_device_ids names the local accelerators this process opens:
    several processes on one GPU host each take their own card (a JAX
    process reserves most of every card it opens, so two on one card
    run out of memory).  None opens every local device (one process per
    host)."""
    import jax

    if coordinator is not None:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id,
                                   local_device_ids=local_device_ids)
    try:
        return jax.process_index(), jax.process_count()
    except Exception:
        return 0, 1


def process_layout(n_blocks: int, process_index: int | None = None,
                   process_count: int | None = None) -> tuple[int, int]:
    """Contiguous block range [start, end) owned by this jax.distributed
    process under the balanced plan (same plan the emulated path tests)."""
    import jax

    if process_index is None:
        process_index = jax.process_index()
    if process_count is None:
        process_count = jax.process_count()
    return plan_block_ranges(n_blocks, process_count)[process_index]


def gather_blocks_to_host0(payloads: list[bytes]) -> list[bytes] | None:
    """Ordered gather of per-block payload bytes onto process 0 (NCCL or
    gloo collectives over NVLink or the network).

    Returns the global payload list in original block order on process 0
    (block ranges are contiguous and ascending by process), None
    elsewhere.  Single-process: identity."""
    import jax

    if jax.process_count() == 1:
        return list(payloads)
    parts = gather_round_to_host0(payloads)
    if parts is None:
        return None
    return [p for plist in parts for p in plist]


def gather_round_to_host0(payloads: list[bytes],
                          known_counts: "np.ndarray | None" = None
                          ) -> list[list[bytes]] | None:
    """One collective gather round: each process contributes its payload
    list; process 0 receives them grouped PER PROCESS (the overlapped
    round-wise gather needs the grouping to reassemble global block order
    across rounds), None elsewhere.

    Up to three `multihost_utils.process_allgather` calls: (1) per-process
    block counts — SKIPPED when the caller passes `known_counts` (the
    overlapped gather's round structure is deterministic from the block
    plan, and per-round collective latency is the tail cost), (2)
    per-block lengths padded to the global max count, (3) the
    concatenated payload bytes padded to the global max total, as uint8 —
    metadata first because allgather needs identical shapes on every
    process.
    """
    import jax
    import jax.numpy as jnp
    from jax.experimental import multihost_utils

    lens = np.asarray([len(p) for p in payloads], np.int32)
    if known_counts is not None:
        counts = np.asarray(known_counts, np.int32).reshape(-1)
        assert counts[jax.process_index()] == len(payloads)
    else:
        counts = np.asarray(multihost_utils.process_allgather(
            jnp.asarray([len(payloads)], jnp.int32))).reshape(-1)
    # Pad to >= 1 so allgather never sees a zero-sized tensor (a round where
    # every process contributes nothing would otherwise gather shape (0,)).
    cmax = max(int(counts.max()), 1)
    lens_pad = np.zeros(cmax, np.int32)
    lens_pad[:lens.shape[0]] = lens
    lens_all = np.asarray(multihost_utils.process_allgather(
        jnp.asarray(lens_pad))).reshape(len(counts), cmax)
    totals = lens_all.sum(axis=1)
    tmax = max(int(totals.max()), 1)

    buf = np.zeros(tmax, np.uint8)
    if lens.size:
        local = np.frombuffer(b"".join(payloads), np.uint8)
        buf[:local.shape[0]] = local
    bufs = np.asarray(multihost_utils.process_allgather(
        jnp.asarray(buf))).reshape(len(counts), tmax)

    if jax.process_index() != 0:
        return None
    out: list[list[bytes]] = []
    for p in range(len(counts)):
        pos = 0
        plist: list[bytes] = []
        for b in range(int(counts[p])):
            n = int(lens_all[p, b])
            plist.append(bufs[p, pos:pos + n].tobytes())
            pos += n
        out.append(plist)
    return out


def plan_block_ranges(n_blocks: int, n_parts: int) -> list[tuple[int, int]]:
    """Contiguous block ranges [start, end) per worker, balanced to within
    one block.  Contiguity keeps each worker's input scan a single window."""
    base = n_blocks // n_parts
    extra = n_blocks % n_parts
    out = []
    start = 0
    for p in range(n_parts):
        size = base + (1 if p < extra else 0)
        out.append((start, start + size))
        start += size
    return out


def _encode_block_range(input_path: str, block_range: tuple[int, int],
                        n_samples: int, opts: CompressorOptions,
                        mac_threshold: int, default_phased: int,
                        aet_dtype, weirdness_strategy,
                        block_voffs=None, on_payload=None) -> list[bytes]:
    """Worker body: encode the records of blocks [start, end) of the input.

    Streams the input, skipping records outside the window (block i covers
    records [i*block_length, (i+1)*block_length)).  With `block_voffs`
    (per-block virtual offsets from the count scan) the stream SEEKS to
    the window instead of decompressing the prefix.  `on_payload` is
    called with each block's payload as it completes, in block order (the
    overlapped gather feeds its rounds from this).
    """
    start_blk, end_blk = block_range
    if start_blk >= end_blk:
        return []
    lo = start_blk * opts.block_length
    hi = end_blk * opts.block_length
    disp = BlockEncodeDispatcher(
        n_samples, opts.block_length, mac_threshold,
        default_phasing=default_phased, aet_dtype=aet_dtype,
        weirdness_strategy=weirdness_strategy,
        device_cls=_device_encoder_cls(opts.device),
        force_device=(opts.device == "jax"
                      or os.environ.get("XSI_DEVICE") == "jax"))
    payloads: list[bytes] = []

    def emit():
        p = disp.serialize()
        payloads.append(p)
        if on_payload is not None:
            on_payload(p)

    inp = GtInput(input_path)
    if block_voffs is not None and start_blk < len(block_voffs):
        inp.seek_fast(lo, int(block_voffs[start_blk]))
    else:
        inp.skip_records(lo)   # lazy: a window beyond EOF iterates empty
    batches = inp.iter_gt_batches(limit=hi - lo)
    if batches is not None:
        # the single-process batch loop with this worker's record window
        # (same segments + xsi_enc_records; byte-identical by the shared
        # chunking and encoder)
        from ..codec.compressor import _gt_loop_batched
        _gt_loop_batched(batches, disp, emit, max_records=hi - lo)
    else:
        for i, rec in enumerate(inp, start=lo):
            if i >= hi:
                break
            if rec.gt is None:
                raise ValueError("Record without GT data cannot be "
                                 "compressed")
            if disp.full:
                emit()
            disp.encode_record(rec.gt, rec.n_alleles)
    inp.close()
    if disp.bcf_lines:
        emit()
    return payloads


def _setup(input_path: str, opts: CompressorOptions):
    """Deterministic per-process setup (every process computes the same)."""
    from ..format.constants import WeirdnessStrategy

    inp = GtInput(input_path)
    samples = inp.samples
    if not samples:
        raise ValueError(f"File {input_path} has no samples")
    n_samples = len(samples)
    default_phased = sniff_default_phased(input_path)
    sniffed_ploidy = sniff_max_ploidy_first_entry(input_path)
    if sniffed_ploidy == 0:
        raise ValueError(f"File {input_path} has no GT entries")
    n_haps = n_samples * 2
    aet_dtype = np.uint16 if n_haps <= 0xFFFF else np.uint32
    mac_threshold = int(n_haps * opts.maf)
    ws = (WeirdnessStrategy.WS_WAH if opts.wah_encode_missing
          else WeirdnessStrategy.WS_SPARSE)
    return (inp, samples, n_samples, default_phased, sniffed_ploidy,
            aet_dtype, mac_threshold, ws)


def _var_segment(input_path: str, output_path: str, opts,
                 start_blk: int, end_blk: int, block_voffs,
                 write_header: bool):
    """One worker's window of the DISTRIBUTED variant pass: seek to the
    window's virtual offset and render its records into a BGZF body
    segment (rank 0 carries the header).  Returns (segment_bytes,
    (rid, pos, rlen, vbeg, vend, n_variants, max_ploidy), var_header),
    or None when the native pass is ineligible (serial fallback).
    BGZF members are self-contained, so segments concatenate into a
    valid BCF; vbeg/vend are segment-local and shift at assembly."""
    import tempfile

    from ..codec.compressor import (
        _native_var_pass_eligible,
        make_variant_header,
    )
    from ..io.sites import encode_bm_indiv

    inp = GtInput(input_path)
    try:
        if not _native_var_pass_eligible(inp):
            return None
        from ..interop.native import native_var_pass_segment
        var_header = make_variant_header(inp.header,
                                         os.path.basename(output_path))
        text = var_header.to_text().encode() + b"\0"
        bm_prefix = encode_bm_indiv(var_header, 0)[:-4]
        gt_key = inp.header.str2idx.get("GT", -1)
        skip = 9 + inp._bcf.header_text_len
    finally:
        inp.close()

    empty = (np.zeros(0, np.int32),) * 3 + (np.zeros(0, np.uint64),) * 2 \
        + (0, 0)
    if start_blk >= end_blk or start_blk >= len(block_voffs):
        return b"", empty, var_header
    max_recs = (end_blk - start_blk) * opts.block_length
    fd, seg = tempfile.mkstemp(suffix=".varseg")
    os.close(fd)
    try:
        rid, pos, rlen, _bm, vbeg, vend, nv, mp = native_var_pass_segment(
            input_path, seg, text, 6, bm_prefix, opts.block_length, gt_key,
            0 if start_blk == 0 else int(block_voffs[start_blk]),
            start_blk * opts.block_length, max_recs, write_header,
            header_skip=skip, cap_hint=max_recs + 1)
        with open(seg, "rb") as f:
            data = f.read()
    finally:
        os.remove(seg)
    return data, (rid, pos, rlen, vbeg, vend, nv, mp), var_header


def _assemble_var_segments(output_path: str, var_header, parts) -> tuple:
    """Process-0 assembly of the distributed variant pass: concatenate
    segment bytes (rank order = record order), append the BGZF EOF,
    shift each segment's voffsets by the bytes before it and build one
    CSI.  Returns (entries, variants, max_ploidy)."""
    from ..io.bgzf import BGZF_EOF
    from ..io.csi import CsiBuilder, depth_for_max_len

    var_path = output_path + XSI_BCF_VAR_EXTENSION
    base = 0
    cols: list = []
    entries = variants = 0
    max_ploidy = 0
    with open(var_path, "wb") as f:
        for data, tup in parts:
            f.write(data)
            rid, pos, rlen, vbeg, vend, nv, mp = tup
            shift = np.uint64(base) << np.uint64(16)
            cols.append((rid, pos, rlen, vbeg + shift, vend + shift))
            entries += rid.shape[0]
            variants += int(nv)
            max_ploidy = max(max_ploidy, int(mp))
            base += len(data)
        f.write(BGZF_EOF)
    rid = np.concatenate([c[0] for c in cols])
    pos = np.concatenate([c[1] for c in cols])
    rlen = np.concatenate([c[2] for c in cols])
    vbeg = np.concatenate([c[3] for c in cols])
    vend = np.concatenate([c[4] for c in cols])
    csi = CsiBuilder(depth=depth_for_max_len(
        max(var_header.contig_lengths.values(), default=0)))
    csi.add_many(rid, pos, pos.astype(np.int64) + np.maximum(rlen, 1),
                 vbeg, vend)
    csi.write(var_path + ".csi", n_ref=len(var_header.dict_contigs))
    return entries, variants, max_ploidy


def _pack_var_tuples(tup) -> bytes:
    import io as _io
    rid, pos, rlen, vbeg, vend, nv, mp = tup
    buf = _io.BytesIO()
    np.savez(buf, rid=rid, pos=pos, rlen=rlen, vbeg=vbeg, vend=vend,
             nv=nv, mp=mp)
    return buf.getvalue()


def _unpack_var_tuples(data: bytes):
    import io as _io
    with np.load(_io.BytesIO(data)) as z:
        return (z["rid"], z["pos"], z["rlen"], z["vbeg"], z["vend"],
                int(z["nv"]), int(z["mp"]))


def _variant_pass(inp, opts, output_path, sniffed_ploidy):
    """Streaming pass over the input: writes the `_var.bcf` + CSI and
    counts entries/variants (the worker-0 half of the pipeline).
    Same gate as the single-process driver so single- and multi-process
    containers stay byte-identical within one environment."""
    from ..codec.compressor import variant_pass_native
    nat = variant_pass_native(inp, opts, output_path, sniffed_ploidy)
    if nat is not None:
        return nat
    var_path = output_path + XSI_BCF_VAR_EXTENSION
    var_header = make_variant_header(inp.header, os.path.basename(output_path))
    var_writer = BcfWriter(var_path, var_header)
    csi = CsiBuilder(depth=depth_for_max_len(
        max(var_header.contig_lengths.values(), default=0)))

    entry_counter = 0
    variant_counter = 0
    max_ploidy = sniffed_ploidy
    bm_alt_offset = 0
    for rec in inp.iter_sites():
        if rec.ploidy > 2:
            raise ValueError("Ploidy higher than 2 is not yet supported")
        bm_block, in_block = divmod(entry_counter, opts.block_length)
        if in_block == 0:
            bm_alt_offset = 0
        if bm_alt_offset >> BM_BLOCK_BITS:
            raise ValueError(
                f"BM offset cannot be represented on {BM_BLOCK_BITS} bits")
        bm = (bm_block << BM_BLOCK_BITS) | bm_alt_offset
        shared = patch_shared_sample_counts(rec.shared, n_fmt=1, n_sample=1)
        vbeg, vend = var_writer.write_raw(
            shared, encode_bm_indiv(var_header, bm))
        rid, pos0, rlen = struct.unpack_from("<iii", shared, 0)
        csi.add(rid, pos0, pos0 + max(rlen, 1), vbeg, vend)
        n_alts = rec.n_alleles - 1
        bm_alt_offset += n_alts
        variant_counter += n_alts
        entry_counter += 1
        max_ploidy = max(max_ploidy, rec.ploidy)
    var_writer.close()
    csi.write(var_path + ".csi", n_ref=len(var_header.dict_contigs))
    return entry_counter, variant_counter, max_ploidy


def compress_file_distributed(input_path: str, output_path: str,
                              opts: CompressorOptions | None = None,
                              n_parts: int = 4) -> dict:
    """Data-parallel compression over `n_parts` emulated workers.

    Produces output byte-identical to codec.compressor.compress_file: the
    block partition/ordered-gather/assembly logic is exactly the multi-host
    plan, with workers run on a thread pool instead of separate hosts.
    """
    opts = opts or CompressorOptions()
    (inp, samples, n_samples, default_phased, sniffed_ploidy,
     aet_dtype, mac_threshold, ws) = _setup(input_path, opts)

    header = XsiHeader(
        version=5, ind_bytes=4, aet_bytes=np.dtype(aet_dtype).itemsize,
        wah_bytes=2, iota_ppa=True, no_sort=False,
        default_phased=bool(default_phased), ss_rate=opts.block_length,
        rare_threshold=mac_threshold)
    xsi = XsiWriter(output_path, header, samples,
                    zstd_on=opts.zstd, zstd_level=opts.zstd_level)
    var_path = output_path + XSI_BCF_VAR_EXTENSION
    entry_counter, variant_counter, max_ploidy = _variant_pass(
        inp, opts, output_path, sniffed_ploidy)
    inp.close()

    # --- partition blocks, encode on workers, ordered gather --------------
    n_blocks = -(-entry_counter // opts.block_length)
    ranges = plan_block_ranges(n_blocks, n_parts)
    with ThreadPoolExecutor(max_workers=n_parts) as pool:
        futures = [
            pool.submit(_encode_block_range, input_path, r, n_samples, opts,
                        mac_threshold, default_phased, aet_dtype, ws)
            for r in ranges
        ]
        gathered = [f.result() for f in futures]

    for payloads in gathered:            # original block order
        for payload in payloads:
            xsi.write_block(payload)
    xsi.finalize(num_variants=variant_counter, xcf_entries=entry_counter,
                 max_ploidy=max_ploidy)

    return {
        "entries": entry_counter,
        "variants": variant_counter,
        "n_blocks": n_blocks,
        "n_parts": n_parts,
        "xsi_bytes": os.path.getsize(output_path),
    }


def compress_file_multihost(input_path: str, output_path: str,
                            opts: CompressorOptions | None = None,
                            coordinator: str | None = None,
                            num_processes: int | None = None,
                            process_id: int | None = None,
                            perf: dict | None = None,
                            local_device_ids: list[int] | None = None
                            ) -> dict | None:
    """Real multi-process data-parallel compression (jax.distributed).

    Every process must see `input_path`; only process 0 writes output.
    Launch one process per host with the same arguments (plus coordinator
    address / process id), e.g. via the CLI's --distributed flags.

    Plan (SURVEY §5 "distributed communication backend"):
      1. every process runs the same deterministic setup (phasing sniff,
         A_T selection, MAC threshold);
      2. process 0 streams the input once, writing `_var.bcf` + CSI and
         counting entries; the others count entries with a light scan;
      3. the entry count is allgathered and cross-checked (every process
         must have seen the same input);
      4. each process encodes its contiguous block range (process_layout),
         device codec on its local chips;
      5. per-block payload bytes gather to process 0 in original block
         order (gather_blocks_to_host0) which assembles the container —
         byte-identical to the single-process output.

    zstd framing (when enabled) is applied by process 0 during assembly,
    mirroring the reference's single-writer container layout.

    Returns the summary dict on process 0, None on other processes.
    """
    import queue
    import threading
    import time

    import jax
    import jax.numpy as jnp
    from jax.experimental import multihost_utils

    t0 = time.perf_counter()
    c0 = time.process_time()
    pidx, pcount = init_distributed(coordinator, num_processes, process_id,
                                    local_device_ids)
    opts = opts or CompressorOptions()
    (inp, samples, n_samples, default_phased, sniffed_ploidy,
     aet_dtype, mac_threshold, ws) = _setup(input_path, opts)
    if perf is not None:
        perf["setup_s"] = time.perf_counter() - t0
        perf["setup_cpu_s"] = time.process_time() - c0

    xsi = None
    var_state: dict = {}
    var_thread = None
    try:
        # Every process (including 0) takes the cheap frame-skip entry
        # count; process 0's full variant pass (sites parse + _var.bcf +
        # CSI) runs on a background thread OVERLAPPED with its encode
        # share below — zlib and numpy both release the GIL, so on a
        # multi-core host the two genuinely run in parallel and the
        # serial fraction shrinks to this count scan (the Amdahl term of
        # the whole pipeline).  Its results are only needed at assembly.
        t0 = time.perf_counter()
        c0 = time.process_time()
        from ..io.unified import count_entries_offsets
        entry_counter, block_voffs = count_entries_offsets(
            input_path, opts.block_length)
        inp.close()
        if perf is not None:
            perf["scan_s"] = time.perf_counter() - t0
            perf["scan_cpu_s"] = time.process_time() - c0

        # DISTRIBUTED variant pass (default on for multi-process runs):
        # every process renders its own record window into a BGZF body
        # segment on a thread overlapped with its encode; process 0
        # concatenates in rank order.  Record contents equal the serial
        # pass; only BGZF member framing differs at segment joins
        # (XSI_DIST_VARPASS=0 restores the serial byte-identical pass).
        dist_var = (pcount > 1 and block_voffs is not None
                    and os.environ.get("XSI_DIST_VARPASS", "1")
                    not in ("0", "off", "no"))
        if pidx == 0:
            header = XsiHeader(
                version=5, ind_bytes=4,
                aet_bytes=np.dtype(aet_dtype).itemsize,
                wah_bytes=2, iota_ppa=True, no_sort=False,
                default_phased=bool(default_phased),
                ss_rate=opts.block_length, rare_threshold=mac_threshold)
            xsi = XsiWriter(output_path, header, samples,
                            zstd_on=opts.zstd, zstd_level=opts.zstd_level)

        if pidx == 0 and not dist_var:
            def _run_variant_pass():
                tt0 = time.thread_time()
                vin = GtInput(input_path)
                try:
                    var_state["result"] = _variant_pass(
                        vin, opts, output_path, sniffed_ploidy)
                except BaseException as exc:   # surfaced at join below
                    var_state["error"] = exc
                finally:
                    vin.close()
                    var_state["cpu_s"] = time.thread_time() - tt0

            var_thread = threading.Thread(target=_run_variant_pass,
                                          name="xsi-variant-pass")
            var_thread.start()

        if pcount > 1:
            counts = np.asarray(multihost_utils.process_allgather(
                jnp.asarray([entry_counter], jnp.int32))).reshape(-1)
            if not (counts == counts[0]).all():
                raise RuntimeError(
                    "processes disagree on input entry count: "
                    f"{counts.tolist()} — every process must read the same "
                    "input file")

        t0 = time.perf_counter()
        c0 = time.thread_time()      # main thread only: variant-pass CPU
        n_blocks = -(-entry_counter // opts.block_length)   # is overlapped
        ranges = plan_block_ranges(n_blocks, pcount)
        start_blk, end_blk = ranges[pidx]

        if dist_var:
            def _run_var_segment():
                tt0 = time.thread_time()
                try:
                    var_state["segment"] = _var_segment(
                        input_path, output_path, opts, start_blk, end_blk,
                        block_voffs, write_header=(pidx == 0))
                except BaseException as exc:   # surfaced at join below
                    var_state["error"] = exc
                finally:
                    var_state["cpu_s"] = time.thread_time() - tt0

            var_thread = threading.Thread(target=_run_var_segment,
                                          name="xsi-var-segment")
            var_thread.start()

        # Overlapped gather: payload bytes stream to process 0 in bounded
        # ROUNDS on a separate thread while encode proceeds, so only the
        # tail round's communication sits on the critical path (the old
        # single end-of-run gather barrier added its full wall clock to
        # every run).  The round count is agreed up front from the
        # deterministic block plan — every process issues the same
        # collective sequence, rounds pacing themselves by each process's
        # own completed chunks.
        max_local = max(e - s for s, e in ranges)
        # ~4 rounds by default: enough for the tail round to be a quarter
        # of the communication, few enough that per-round collective
        # latency never outgrows the encode span it hides behind.  (A
        # payload-adaptive round count was tried and reverted: cutting to
        # one round removes ALL overlap, and the per-round cost is
        # latency-bound, so fewer+bigger rounds strictly lengthen the
        # unhidden tail.)
        chunk_env = os.environ.get("XSI_GATHER_CHUNK_BLOCKS")
        chunk = (max(1, int(chunk_env)) if chunk_env
                 else max(1, -(-max_local // 4)))
        rounds = -(-max_local // chunk) if pcount > 1 else 0
        local_blocks = end_blk - start_blk
        gather_exc: list[BaseException] = []
        parts: list[list[bytes]] = [[] for _ in range(pcount)]
        payload_q: "queue.Queue[bytes]" = queue.Queue()
        gather_wait = [0.0]

        def gather_loop():
            try:
                for r in range(rounds):
                    need = max(min(chunk, local_blocks - r * chunk), 0)
                    batch = [payload_q.get() for _ in range(need)]
                    # per-round per-process counts are deterministic from
                    # the plan: skip that collective (one less round-trip)
                    kc = np.asarray(
                        [max(min(chunk, (e - s) - r * chunk), 0)
                         for s, e in ranges], np.int32)
                    tg = time.perf_counter()
                    res = gather_round_to_host0(batch, known_counts=kc)
                    gather_wait[0] += time.perf_counter() - tg
                    if pidx == 0:
                        for p in range(pcount):
                            parts[p].extend(res[p])
            except BaseException as exc:   # surfaced at join below
                gather_exc.append(exc)

        gthread = None
        if rounds:
            # daemon: an encode failure starves the queue; the cleanup
            # path must not block on a collective that can never complete
            gthread = threading.Thread(target=gather_loop, daemon=True,
                                       name="xsi-gather")
            gthread.start()
        payloads = _encode_block_range(
            input_path, (start_blk, end_blk), n_samples, opts,
            mac_threshold, default_phased, aet_dtype, ws,
            block_voffs=block_voffs,
            on_payload=(payload_q.put if rounds else None))
        if perf is not None:
            perf["encode_s"] = time.perf_counter() - t0
            perf["encode_cpu_s"] = time.thread_time() - c0
            perf["payload_bytes"] = sum(len(p) for p in payloads)
            perf["payload_lens"] = [len(p) for p in payloads]
            perf["n_local_blocks"] = len(payloads)

        t0 = time.perf_counter()
        if gthread is not None:
            gthread.join()
            if gather_exc:
                raise RuntimeError(
                    "overlapped gather failed") from gather_exc[0]
            gathered = ([p for plist in parts for p in plist]
                        if pidx == 0 else None)
        else:
            gathered = gather_blocks_to_host0(payloads)
        if perf is not None:
            # gather_s: the RESIDUAL communication on the critical path
            # (time from local encode completion to gather completion);
            # gather_collective_s: total time inside collectives, mostly
            # hidden behind encode
            perf["gather_s"] = time.perf_counter() - t0
            perf["gather_rounds"] = rounds
            perf["gather_chunk"] = chunk
            perf["gather_collective_s"] = round(gather_wait[0], 4)
        if dist_var:
            # one extra collective round carries the var segments + CSI
            # tuples (every process participates before rank gating)
            var_thread.join()
            if "error" in var_state:
                raise RuntimeError(
                    "variant pass failed") from var_state["error"]
            seg = var_state["segment"]
            if seg is not None:
                data, tup, var_header_l = seg
                res = gather_round_to_host0([data, _pack_var_tuples(tup)])
                if pidx == 0:
                    parts = [(plist[0], _unpack_var_tuples(plist[1]))
                             for plist in res]
                    e_, v_, mp_ = _assemble_var_segments(
                        output_path, var_header_l, parts)
                    var_state["result"] = (e_, v_,
                                           max(mp_, sniffed_ploidy))
            elif pidx == 0:
                # native pass ineligible (deterministic across processes:
                # input format + env gates): serial fallback, unoverlapped
                vin = GtInput(input_path)
                try:
                    var_state["result"] = _variant_pass(
                        vin, opts, output_path, sniffed_ploidy)
                finally:
                    vin.close()
        if pidx != 0:
            return None

        if not dist_var:
            var_thread.join()
        if "error" in var_state:
            raise RuntimeError("variant pass failed") from var_state["error"]
        ventries, variant_counter, max_ploidy = var_state["result"]
        if ventries != entry_counter:
            raise RuntimeError(
                f"variant pass saw {ventries} entries, count saw "
                f"{entry_counter} — input changed mid-run?")
        if perf is not None:
            perf["varpass_cpu_s"] = var_state["cpu_s"]

        t0 = time.perf_counter()
        c0 = time.process_time()
        for payload in gathered:                 # original block order
            xsi.write_block(payload)
        xsi.finalize(num_variants=variant_counter, xcf_entries=entry_counter,
                     max_ploidy=max_ploidy)
        if perf is not None:
            perf["assemble_s"] = time.perf_counter() - t0
            perf["assemble_cpu_s"] = time.process_time() - c0
    except BaseException:
        # don't leave a truncated container/variant file behind on
        # process 0 (mirrors compress_file's failure cleanup)
        if pidx == 0:
            if var_thread is not None:
                var_thread.join()      # let it finish before unlinking
            try:
                if xsi is not None and not xsi.f.closed:
                    xsi.f.close()
            except Exception:
                pass
            var_path = output_path + XSI_BCF_VAR_EXTENSION
            for path in (output_path, var_path, var_path + ".csi"):
                try:
                    os.unlink(path)
                except OSError:
                    pass
        raise
    return {
        "entries": entry_counter,
        "variants": variant_counter,
        "n_samples": n_samples,
        "n_blocks": n_blocks,
        "n_processes": pcount,
        "xsi_bytes": os.path.getsize(output_path),
        "variant_bytes": os.path.getsize(
            output_path + XSI_BCF_VAR_EXTENSION),
    }


def _native_segment_bytes(d, start_blk: int, end_blk: int,
                          pidx: int) -> tuple[bytes, int] | None:
    """This worker's BCF body segment through the native extract loop
    (xsi_extract_segment: decode + frame + BGZF deflate in C), or None
    when the native path is ineligible (sample subset, filters, explicit
    codec selection, lib unavailable) — the Python driver then runs."""
    import os as _os
    import tempfile

    o = d.opts
    if (d._select is not None or o.regions or o.targets
            or o.device != "auto"
            or _os.environ.get("XSI_DEVICE") in ("numpy", "jax")
            or _os.environ.get("XSI_NATIVE", "1") in ("0", "off", "no")):
        return None
    try:
        from ..interop.native import build_native, native_extract_segment
        build_native()
    except Exception:
        return None
    header = d.output_header()
    gt_key = header.ensure_string(
        "GT", '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">')
    text = header.to_text().encode() + b"\0"
    # seek straight to this worker's var.bcf window: one cheap native
    # frame walk captures per-block virtual offsets (the compress side's
    # trick), so workers skip zero prefix records
    chunks = None
    try:
        from ..io.unified import count_entries_offsets
        block_len = d.xsi.header.ss_rate
        n_recs, voffs = count_entries_offsets(d.var_path, block_len)
        if voffs is not None and start_blk < len(voffs):
            end_v = (int(voffs[end_blk]) if end_blk < len(voffs)
                     else (1 << 62))
            chunks = [(int(voffs[start_blk]), end_v)]
    except Exception:
        chunks = None
    fd, seg_path = tempfile.mkstemp(suffix=".bcfseg")
    _os.close(fd)
    try:
        n = native_extract_segment(d.xsi_path, seg_path, text, gt_key, 6,
                                   start_blk, end_blk,
                                   write_header=(pidx == 0),
                                   write_eof=False, chunks=chunks)
        with open(seg_path, "rb") as f:
            return f.read(), n
    finally:
        _os.remove(seg_path)


def decompress_file_multihost(xsi_path: str, output_path: str,
                              opts=None,
                              coordinator: str | None = None,
                              num_processes: int | None = None,
                              process_id: int | None = None,
                              local_device_ids: list[int] | None = None
                              ) -> dict | None:
    """Multi-process decompression to BCF (beyond-reference scale-out).

    Blocks are independently decodable, so each process decodes its
    contiguous block range and emits a records-only BGZF body segment;
    BGZF members concatenate cleanly, so process 0 writes
    [header segment][body 0]...[body N-1][EOF] — a valid BCF with the
    records in original order.  Output equals the single-process
    extraction record for record (BGZF block boundaries differ at
    segment joins, so bytes are not identical — contents are).

    Only -O b output is supported multi-host.  Returns the summary dict on
    process 0, None elsewhere.
    """
    import io as _io

    from ..codec.decompressor import Decompressor, DecompressorOptions
    from ..io.bgzf import BGZF_EOF

    pidx, pcount = init_distributed(coordinator, num_processes, process_id,
                                    local_device_ids)
    opts = opts or DecompressorOptions()
    if opts.output_type not in ("b",):
        raise ValueError("multi-host decompression supports -O b output")

    import jax.numpy as jnp
    from jax.experimental import multihost_utils

    d = Decompressor(xsi_path, opts)
    n_blocks = d.xsi.n_blocks()
    start_blk, end_blk = process_layout(max(n_blocks, 1), pidx, pcount)
    d.opts.block_range = (start_blk, end_blk)

    native_seg = _native_segment_bytes(d, start_blk, end_blk, pidx)
    if native_seg is not None:
        data, n_rec = native_seg
        stats = d._emit_stats(n_rec)
    else:
        body = _io.BytesIO()
        stats = d._decompress_to_bcf(body, write_header=(pidx == 0),
                                     write_eof=False)
        data = body.getvalue()
        del body
    # Gather in bounded ROUNDS: one 256 MB piece per process per round
    # (piece k of every process), streamed straight to per-process spill
    # files on process 0 and concatenated in process order -- peak memory
    # stays at P x 256 MB however large the bodies are, and the int32
    # length metadata of the gather never overflows.
    chunk = 1 << 28
    n_pieces = max(-(-len(data) // chunk), 1)
    rounds = int(np.asarray(multihost_utils.process_allgather(
        jnp.asarray([n_pieces], jnp.int32))).max()) if pcount > 1 else n_pieces

    try:
        spool = None
        if pidx == 0:
            import tempfile
            spool = [tempfile.TemporaryFile() for _ in range(pcount)]
        for k in range(rounds):
            piece = data[k * chunk:(k + 1) * chunk]
            segs = gather_blocks_to_host0([piece])
            if pidx == 0:
                for p, seg in enumerate(segs):
                    spool[p].write(seg)
        # total record count across processes (stats above covers only this
        # process's block range)
        if pcount > 1:
            totals = np.asarray(multihost_utils.process_allgather(
                jnp.asarray([stats["records"]], jnp.int32))).reshape(-1)
        else:
            totals = np.asarray([stats["records"]])
        if pidx != 0:
            return None
        with open(output_path, "wb") as f:
            for p in range(pcount):
                spool[p].seek(0)
                while True:
                    buf = spool[p].read(1 << 24)
                    if not buf:
                        break
                    f.write(buf)
            f.write(BGZF_EOF)
    finally:
        if spool is not None:
            for s in spool:
                s.close()
    stats["records"] = int(totals.sum())
    stats["n_blocks"] = n_blocks
    stats["n_processes"] = pcount
    return stats
