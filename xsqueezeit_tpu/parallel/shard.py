"""Multi-chip block parallelism.

Variant blocks are embarrassingly parallel (the PBWT arrangement re-seeds to
identity at every block boundary -- header flag iota_ppa), so scale-out is
data parallelism over the block axis of a `jax.sharding.Mesh`:

  * each device runs the fused per-block encode (PBWT scan + WAH RLE +
    sparse compaction) on its shard of blocks,
  * per-block compressed sizes are summed with a `psum` (NCCL over NVLink
    between the cards of one host),
  * outputs are gathered in original block order (the out_specs partition
    preserves the block axis ordering), so host 0 can write a container
    byte-identical to the single-chip result.

Multi-process runs layer `jax.distributed` on top; the dry-run path
exercises the same program on N virtual CPU devices.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..utils.jaxcache import ensure_compilation_cache

ensure_compilation_cache()


def make_sharded_encoder(mesh: Mesh, axis: str = "blocks",
                         sparse_cap: int = 8):
    """Build a pjit-ed multi-block encoder over `mesh` — the compact
    formulation (host-known line classes; the chain runs over each
    block's gathered WAH rows only, codec.encoder_jax
    .encode_block_core_compact).

    Returned fn: (alleles int8[B, L, H], alts int32[B, L],
                  is_wah bool[B, L], negated bool[B, L],
                  wah_rows int32[B, Lw], sorts_w bool[B, Lw],
                  sparse_rows int32[B, Ls], negated_s bool[B, Ls]) ->
        dict of per-block outputs gathered in block order +
        "total_bytes" (psum over all devices).
    """
    from ..codec.encoder_jax import encode_block_core_compact

    def one(al, at, iw, ng, wr, sw, sr, ns):
        out = encode_block_core_compact(al, at, iw, ng, wr, sw, sparse_cap,
                                        sparse_rows=sr, negated_s=ns)
        # sparse entries serialize in A_T units: 2 B while n_haps fits u16
        aet_bytes = 2 if al.shape[1] <= 0xFFFF else 4
        # valid sparse rows are front-packed; padding block lines carry
        # alts = -100, so the true count excludes them
        n_sp = jnp.sum((~iw & (at >= 0)).astype(jnp.int32))
        out["n_bytes"] = (jnp.sum(jnp.where(sw, out["wah_len"], 0)) * 2
                          + jnp.sum(jnp.where(
                              jnp.arange(ns.shape[0]) < n_sp,
                              out["sparse_len"] + 1, 0)) * aet_bytes)
        return out

    def per_shard(alleles, alts, is_wah, negated, wah_rows, sorts_w,
                  sparse_rows, negated_s):
        out = jax.vmap(one)(alleles, alts, is_wah, negated, wah_rows,
                            sorts_w, sparse_rows, negated_s)
        local_bytes = jnp.sum(out.pop("n_bytes"))
        out["total_bytes"] = jax.lax.psum(local_bytes, axis)
        return out

    from jax import shard_map

    sharded = shard_map(
        per_shard, mesh=mesh,
        in_specs=(P(axis, None, None), P(axis, None), P(axis, None),
                  P(axis, None), P(axis, None), P(axis, None),
                  P(axis, None), P(axis, None)),
        out_specs={
            "wah_words": P(axis, None, None),
            "wah_len": P(axis, None),
            "sparse_idx": P(axis, None, None),
            "sparse_len": P(axis, None),
            "total_bytes": P(),
        },
        check_vma=False,
    )
    return jax.jit(sharded)


def local_mesh(max_devices: int | None = None) -> Mesh | None:
    """A 1-D block mesh over this process's local devices, or None when
    only one device is visible (single-chip path).  XSI_LOCAL_DEVICES caps
    the count (XSI_LOCAL_DEVICES=1 disables the mesh — used by the
    byte-identity tests to produce the single-device reference output)."""
    import os

    devs = jax.local_devices()
    cap = os.environ.get("XSI_LOCAL_DEVICES")
    if cap is not None:
        devs = devs[:max(int(cap), 1)]
    if max_devices is not None:
        devs = devs[:max_devices]
    if len(devs) <= 1:
        return None
    return Mesh(np.asarray(devs), ("blocks",))


class MeshBlockEncoder:
    """Production multi-chip block encode: batches of prepared blocks run
    through one shard_map'd program (data parallelism over the block axis,
    SURVEY §2/§7 stage 6 — the generalized form of the reference's 2-thread
    split at xsqueezeit.cpp:120-148), and each block's payload is assembled
    by the SAME host code as the single-chip path, so the container bytes
    are identical whatever the device count.
    """

    def __init__(self, mesh: Mesh, mac_threshold: int):
        self.mesh = mesh
        self.n_dev = mesh.devices.size
        self.mac_threshold = int(mac_threshold)
        self.sparse_cap = max(self.mac_threshold, 1)
        self._fn = make_sharded_encoder(mesh, sparse_cap=self.sparse_cap)

    def encode_batch(self, encoders: list) -> list[bytes]:
        """encoders: DeviceBlockEncoder instances holding buffered records.
        Returns each block's serialized payload, in order."""
        preps = [e.prepare() for e in encoders]
        H = preps[0]["H"]
        if any(p["H"] != H for p in preps) or any(p["mixed"] for p in preps):
            # mixed diploid/haploid widths (or mixed-ploidy blocks, which
            # take the parity kernel) across the batch: encode each block
            # on its own (still device, just not batched)
            return [e.serialize_prepared(p) for e, p in
                    zip(encoders, preps)]
        L_pad = max(p["alleles_p"].shape[0] for p in preps)
        Lw_pad = max(p["wah_rows_p"].shape[0] for p in preps)
        Ls_pad = max(p["sparse_rows_p"].shape[0] for p in preps)
        B = len(preps)
        B_pad = -(-B // self.n_dev) * self.n_dev
        alleles = np.full((B_pad, L_pad, H), -3, np.int16)
        alts = np.full((B_pad, L_pad), -100, np.int32)
        is_wah = np.zeros((B_pad, L_pad), bool)
        negated = np.zeros((B_pad, L_pad), bool)
        wah_rows = np.zeros((B_pad, Lw_pad), np.int32)
        sorts_w = np.zeros((B_pad, Lw_pad), bool)
        sparse_rows = np.zeros((B_pad, Ls_pad), np.int32)
        negated_s = np.zeros((B_pad, Ls_pad), bool)
        for i, p in enumerate(preps):
            lp = p["alleles_p"].shape[0]
            lw = p["wah_rows_p"].shape[0]
            ls = p["sparse_rows_p"].shape[0]
            alleles[i, :lp] = p["alleles_p"]
            alts[i, :lp] = p["alts_p"]
            is_wah[i, :lp] = p["is_wah_p"]
            negated[i, :lp] = p["negated_p"]
            wah_rows[i, :lw] = p["wah_rows_p"]
            sorts_w[i, :lw] = p["sorts_w"]
            sparse_rows[i, :ls] = p["sparse_rows_p"]
            negated_s[i, :ls] = p["negated_s"]
        # each device receives only its own blocks: placing the batch
        # whole on one device first would stage B x [L, H] there and
        # reshard it inside the program
        blocks = NamedSharding(self.mesh, P("blocks"))
        out = self._fn(*jax.device_put(
            (alleles, alts, is_wah, negated, wah_rows, sorts_w,
             sparse_rows, negated_s), blocks))
        out = {k: np.asarray(v) for k, v in out.items() if k != "total_bytes"}
        payloads = []
        for i, (e, p) in enumerate(zip(encoders, preps)):
            nw, ns = p["n_wah"], p["n_sparse"]
            block_out = {
                "is_wah": p["is_wah"],
                "negated": p["negated"],
                "wah_compact": True,
                "sparse_compact": True,
                "wah_words": out["wah_words"][i][:nw],
                "wah_len": out["wah_len"][i][:nw],
                "sparse_idx": out["sparse_idx"][i][:ns],
                "sparse_len": out["sparse_len"][i][:ns],
            }
            payloads.append(e.assemble(block_out, p))
        return payloads


def make_sharded_block_decoder(mesh: Mesh, axis: str = "blocks"):
    """Full mixed-block decoder over the mesh: WAH lines AND sparse lines
    (carrier scatter + negated-row fold) land in natural line order, the
    same fused program as codec.decoder_jax._decode_block_full vmapped over
    each device's shard of blocks.

    fn = build(h, w); fn(stream u16[B, N], sorts bool[B, Lw],
                         rank i32[B, Lp], is_wah bool[B, Lp],
                         neg u8[B, Lp], car_line i32[B, Nc],
                         car_idx i32[B, Nc]) -> vals uint8[B, Lp, h]
    """
    from ..codec.decoder_jax import _decode_block_full

    from jax import shard_map

    def per_shard(stream, sorts, rank, is_wah, neg, car_line, car_idx, h, w):
        return jax.vmap(
            lambda s, so, r, iw, ng, cl, ci:
            _decode_block_full(s, so, r, iw, ng, cl, ci, h, w)
        )(stream, sorts, rank, is_wah, neg, car_line, car_idx)

    def build(h: int, w: int):
        sharded = shard_map(
            functools.partial(per_shard, h=h, w=w), mesh=mesh,
            in_specs=(P(axis, None), P(axis, None), P(axis, None),
                      P(axis, None), P(axis, None), P(axis, None),
                      P(axis, None)),
            out_specs=P(axis, None, None),
            check_vma=False,
        )
        return jax.jit(sharded)

    return build
