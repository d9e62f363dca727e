"""Node-partitioned aggregation with one boundary exchange a layer
(counterpart of ``gcn_tpu.parallel.halo``).

Under ``graph_partition="halo"`` the ``model`` group's K ranks hold the
same rows of a batch, and the node axis of those rows is cut into K
contiguous slabs of ``S = ceil(N/K)`` nodes (the axis padded to K·S):
model rank m owns nodes ``[m·S, (m+1)·S)``.  From the first GCN layer to
the last a rank holds only its slab of the node features, [B, S, H].

Each edge lives on the rank that owns its destination, so the scatter-adds
are local.  A static plan built on the host (``build_halo_plan``, carried
in the batch as ``hplan_*`` arrays by ``attach_halo_plans``) lists for
each pair of ranks (j → k) the boundary nodes k needs from j, deduplicated
in first-seen order and padded to a static width Hp.  A layer gathers the
rows every peer asked for into one contiguous [K, B, Hp_f + Hp_r, H]
buffer, for both bands at once, and makes one ``all_to_all_single`` over
the model group (``halo_exchange``: dim 0 split and concatenated, gcn_tpu's
``lax.all_to_all(split_axis=0, concat_axis=0, tiled=False)``).  Each band
then scatters its local-source edges from the rank's own slab and its
halo-source edges from the extended buffer (own slab ++ received rows,
slot ``S + j·Hp + i``).  The gathers and scatters are ``ops.spmm``'s.

On the card the exchange runs on the CUDA tensors themselves, under NCCL
or gloo alike; no copy to the host is made.

The autograd rules.  Every model rank computes the same loss from the same
rows, and every rule below keeps it so:

* entering the GCN stack, ``scatter_to_slab``: the forward takes this
  rank's slab of the whole [B, N, D] tensor (padded to K·S nodes); the
  backward all-gathers the slab gradients over the group, so the BiLSTM
  and the embeddings get their whole gradient on every rank;
* leaving it, before pooling, ``gather_from_slabs``: the forward is an
  all-gather and a cut to [:, :N]; the backward takes the rank's own slab
  of the gradient;
* the exchange (``halo_exchange``) is its own transpose: its backward is
  the same exchange of the gradient;
* a parameter read on the slab (the GCN weights and biases, the deprel
  weights and table that the composed matrices and the gates come from,
  attention's ``W_q`` and ``W_k``) has a gradient from its own slab only:
  the layer reads it through ``edge_partition.copy_to_model`` (identity
  forward, all-reduce backward), so every rank ends the backward with the
  whole parameter gradients, and the trainer sums over the ``data`` group
  only, as for ``edges``;
* every dropout mask is drawn on the whole tensor from the same generator
  calls as the unpartitioned forward and then cut to the slab
  (``slab_dropout``), so a 1 × K world draws ``Trainer``'s masks; edge
  dropout's whole [B, E] keep mask is mapped onto the plan's slots by
  ``masks_with_edge_keep``;
* degrees and denominators come from the whole edge lists, then are cut to
  the slab (``SlabLayout.cut``).

An edge with an end outside [0, N) is dropped whole (the port's rule, as
``ops.spmm``): ``build_halo_plan`` masks such edges out before planning.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from gcn_tpu_torch.ops.dropout import bernoulli
from gcn_tpu_torch.ops.spmm import gather_rows, scatter_rows


@dataclass
class HaloPlan:
    """Static-shape exchange plan for one batch of forests.

    All index arrays are in *local* coordinates.  ``requests[j, k, b, i]``
    is the i-th node (local to owner j) that device k needs from j for
    example b; the received feature lands at extended-buffer slot
    ``S + j·Hp + i`` on device k.
    """

    n_devices: int
    slab: int                 # S: nodes per device (node axis padded to K·S)
    halo_width: int           # Hp: per-pair request capacity
    requests: np.ndarray      # [K, K, B, Hp] int32 (sender-local node ids)
    request_mask: np.ndarray  # [K, K, B, Hp] bool
    local_dst: np.ndarray     # [K, B, El] int32 (slab-local destination)
    local_src: np.ndarray     # [K, B, El] int32 (slab-local source)
    local_mask: np.ndarray    # [K, B, El] bool
    halo_dst: np.ndarray      # [K, B, Eh] int32 (slab-local destination)
    halo_src: np.ndarray      # [K, B, Eh] int32 (extended-buffer source ≥ S)
    halo_mask: np.ndarray     # [K, B, Eh] bool
    # the batch's edge index e of each slot, which maps a [B, E] keep mask
    # (edge dropout) onto the slot masks
    local_edge: np.ndarray    # [K, B, El] int32
    halo_edge: np.ndarray     # [K, B, Eh] int32


def _group_positions(codes: np.ndarray) -> tuple[np.ndarray, int]:
    """For SORTED group codes, the 0-based position of each element within
    its group and the largest group size (≥1 for empty input)."""
    m = codes.shape[0]
    if m == 0:
        return np.zeros(0, np.int64), 1
    starts = np.r_[0, np.nonzero(np.diff(codes))[0] + 1]
    sizes = np.diff(np.r_[starts, m])
    pos = np.arange(m, dtype=np.int64) - np.repeat(starts, sizes)
    return pos, int(sizes.max())


def build_halo_plan(
    edge_parent: np.ndarray,  # [B, E]
    edge_child: np.ndarray,   # [B, E]
    edge_mask: np.ndarray,    # [B, E]
    n: int,
    n_devices: int,
    reverse: bool = False,
    pad_to: tuple[int, int, int] | None = None,
) -> HaloPlan:
    """Host-side partitioning of a batched edge list.

    ``reverse=False`` plans ``A_f @ h`` (messages child→parent: destination
    = parent); ``reverse=True`` plans ``A_fᵀ @ h``.  Vectorized numpy
    (grouped cumcounts over the flattened masked-edge list): edge order
    within each (device, example) group and first-seen request order are
    those of a loop over the edges in (b, e) order.

    ``pad_to=(hp, el, eh)`` pads the capacity dimensions to static budgets,
    so that every batch of a bucket has the same shapes.

    An edge with an end outside [0, n) is left out, as ``ops.spmm`` drops
    it.
    """
    b_sz, _ = edge_parent.shape
    k = n_devices
    slab = -(-n // k)  # ceil: node axis conceptually padded to k*slab

    dst_all = (edge_child if reverse else edge_parent).astype(np.int64)
    src_all = (edge_parent if reverse else edge_child).astype(np.int64)
    inside = ((dst_all >= 0) & (dst_all < n) & (src_all >= 0)
              & (src_all < n))

    b_idx, e_idx = np.nonzero(np.asarray(edge_mask, bool) & inside)
    dst = dst_all[b_idx, e_idx]
    src = src_all[b_idx, e_idx]
    kd = dst // slab
    ks = src // slab
    is_local = kd == ks

    # ---- local edges: per (kd, b) slots in edge order -------------------
    lk, lb = kd[is_local], b_idx[is_local]
    # a stable sort by (kd, b) keeps the (b, e) order within each group
    lorder = np.argsort(lk * b_sz + lb, kind="stable")
    lpos, el = _group_positions((lk * b_sz + lb)[lorder])

    # ---- halo edges -----------------------------------------------------
    hks, hkd, hb = ks[~is_local], kd[~is_local], b_idx[~is_local]
    hdst_l = (dst - kd * slab)[~is_local]
    hsrc = src[~is_local]
    # request dedup per (ks, kd, b, src), position = first-seen rank
    gq = (hks * k + hkd) * b_sz + hb                  # request group
    code = gq * (k * slab) + hsrc                     # group × source node
    _, uidx, uinv = np.unique(code, return_index=True, return_inverse=True)
    ugq = gq[uidx]
    uo = np.lexsort((uidx, ugq))                      # group, then 1st-seen
    upos_sorted, hp_data = _group_positions(ugq[uo])
    upos = np.empty(uidx.shape[0], np.int64)
    upos[uo] = upos_sorted
    edge_req_pos = upos[uinv]                         # per halo edge
    # per (kd, b) halo-edge slots in edge order
    horder = np.argsort(hkd * b_sz + hb, kind="stable")
    hpos, eh = _group_positions((hkd * b_sz + hb)[horder])

    hp = hp_data if uidx.shape[0] else 1
    if pad_to is not None:
        hp_b, el_b, eh_b = pad_to
        if hp > hp_b or el > el_b or eh > eh_b:
            raise ValueError(
                f"halo plan exceeds static budget: need ({hp},{el},{eh}) "
                f"> budget ({hp_b},{el_b},{eh_b})")
        hp, el, eh = hp_b, el_b, eh_b

    req_arr = np.zeros((k, k, b_sz, hp), np.int32)
    req_mask = np.zeros((k, k, b_sz, hp), bool)
    if uidx.shape[0]:
        req_arr[hks[uidx], hkd[uidx], hb[uidx], upos] = (
            hsrc[uidx] - hks[uidx] * slab)
        req_mask[hks[uidx], hkd[uidx], hb[uidx], upos] = True

    l_dst = np.zeros((k, b_sz, el), np.int32)
    l_src = np.zeros((k, b_sz, el), np.int32)
    l_mask = np.zeros((k, b_sz, el), bool)
    l_edge = np.zeros((k, b_sz, el), np.int32)
    if lk.shape[0]:
        lko, lbo = lk[lorder], lb[lorder]
        l_dst[lko, lbo, lpos] = (dst - kd * slab)[is_local][lorder]
        l_src[lko, lbo, lpos] = (src - ks * slab)[is_local][lorder]
        l_mask[lko, lbo, lpos] = True
        l_edge[lko, lbo, lpos] = e_idx[is_local][lorder]

    h_dst = np.zeros((k, b_sz, eh), np.int32)
    h_src = np.zeros((k, b_sz, eh), np.int32)
    h_mask = np.zeros((k, b_sz, eh), bool)
    h_edge = np.zeros((k, b_sz, eh), np.int32)
    if hks.shape[0]:
        hko, hbo = hkd[horder], hb[horder]
        h_dst[hko, hbo, hpos] = hdst_l[horder]
        h_src[hko, hbo, hpos] = (slab + hks * hp + edge_req_pos)[horder]
        h_mask[hko, hbo, hpos] = True
        h_edge[hko, hbo, hpos] = e_idx[~is_local][horder]

    return HaloPlan(
        n_devices=k, slab=slab, halo_width=hp,
        requests=req_arr, request_mask=req_mask,
        local_dst=l_dst, local_src=l_src, local_mask=l_mask,
        halo_dst=h_dst, halo_src=h_src, halo_mask=h_mask,
        local_edge=l_edge, halo_edge=h_edge,
    )


# ------------------------------------------------------- batch integration
# A batch carries its plans as ``hplan_{f,r}_{req,reqm,ldst,lsrc,lmask,
# hdst,hsrc,hmask}`` for the forward (A_f @ x) and reverse (A_fᵀ @ x)
# bands, plus the slots' edge indices ``hplan_{f,r}_{ledge,hedge}``.

_PLAN_FIELDS = (
    ("req", "requests"), ("reqm", "request_mask"),
    ("ldst", "local_dst"), ("lsrc", "local_src"), ("lmask", "local_mask"),
    ("hdst", "halo_dst"), ("hsrc", "halo_src"), ("hmask", "halo_mask"),
)

# carried beside the plan, not part of the aggregates' arguments
_EDGE_SLOT_FIELDS = (("ledge", "local_edge"), ("hedge", "halo_edge"))


def is_plan_key(key: str) -> bool:
    return key.startswith("hplan_")


def attach_halo_plans(batch: dict, n: int, n_devices: int) -> dict:
    """The host batch extended with the ``hplan_*`` arrays of its forward
    and reverse plans, at static budgets (the same for every batch of a
    bucket): a pair's request capacity is the slab (requests are
    deduplicated by source node, so a peer never needs more than one whole
    slab), the local and halo edge capacities are E."""
    k = n_devices
    slab = -(-n // k)
    e_cap = int(batch["edge_parent"].shape[1])
    out = dict(batch)
    for tag, reverse in (("f", False), ("r", True)):
        plan = build_halo_plan(
            np.asarray(batch["edge_parent"]),
            np.asarray(batch["edge_child"]),
            np.asarray(batch["edge_mask"]),
            n, k, reverse=reverse, pad_to=(slab, e_cap, e_cap),
        )
        for short, field in _PLAN_FIELDS + _EDGE_SLOT_FIELDS:
            out[f"hplan_{tag}_{short}"] = getattr(plan, field)
    return out


def plans_from_batch(batch: dict, tag: str):
    """The 8 plan arrays of one band ('f' or 'r'), in the aggregates'
    argument order."""
    return tuple(batch[f"hplan_{tag}_{short}"] for short, _ in _PLAN_FIELDS)


def edge_slots_from_batch(batch: dict, tag: str):
    """The (local_edge, halo_edge) slot edge indices of one band."""
    return (batch[f"hplan_{tag}_ledge"], batch[f"hplan_{tag}_hedge"])


def masks_with_edge_keep(arrs: tuple, slots: tuple, edge_keep) -> tuple:
    """Plan arrays with the slot masks ANDed against a per-edge [B, E]
    keep mask (dropped: False), on every device's rows [K, B, E*]."""
    l_edge, h_edge = slots
    (req, reqm, ldst, lsrc, lmask, hdst, hsrc, hmask) = arrs
    b_ix = torch.arange(edge_keep.shape[0],
                        device=edge_keep.device)[None, :, None]
    lmask = lmask & edge_keep[b_ix, l_edge.long()]
    hmask = hmask & edge_keep[b_ix, h_edge.long()]
    return (req, reqm, ldst, lsrc, lmask, hdst, hsrc, hmask)


# ------------------------------------------------------------- the slabs
@dataclass(frozen=True)
class SlabLayout:
    """This model rank's slab of an N-node axis: nodes ``[lo, lo + slab)``
    of the axis padded to ``k·slab``."""
    group: object   # the model group (None: the default group)
    k: int
    index: int
    n: int

    @property
    def slab(self) -> int:
        return -(-self.n // self.k)

    @property
    def lo(self) -> int:
        return self.index * self.slab

    def cut(self, t: torch.Tensor, fill=0) -> torch.Tensor:
        """This rank's slab [B, S, ...] of a whole [B, N, ...] tensor that
        every rank holds, the nodes past N ``fill`` (differentiable,
        local)."""
        extra = self.k * self.slab - t.shape[1]
        if extra:
            tail = t.new_full((t.shape[0], extra, *t.shape[2:]), fill)
            t = torch.cat([t, tail], dim=1)
        return t[:, self.lo:self.lo + self.slab]


def layout_of(part, n: int) -> SlabLayout:
    """The slab layout of ``part`` (a halo ``Partition``) over N nodes."""
    return SlabLayout(part.groups.model, part.mesh.model,
                      part.groups.model_index, n)


def _all_gather_slabs(x: torch.Tensor, lay: SlabLayout) -> torch.Tensor:
    """Every rank's [B, S, ...] slab → the whole [B, N, ...] tensor."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(lay.k)]
    dist.all_gather(parts, x, group=lay.group)
    return torch.cat(parts, dim=1)[:, :lay.n]


class _ScatterToSlab(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lay):
        ctx.lay = lay
        return lay.cut(x).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather_slabs(g, ctx.lay), None


class _GatherFromSlabs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lay):
        ctx.lay = lay
        return _all_gather_slabs(x, lay)

    @staticmethod
    def backward(ctx, g):
        return ctx.lay.cut(g).contiguous(), None


def scatter_to_slab(x: torch.Tensor, lay: SlabLayout) -> torch.Tensor:
    """This rank's slab of the whole [B, N, D] ``x``; the gradient of the
    whole ``x`` is every rank's slab gradient, all-gathered."""
    return _ScatterToSlab.apply(x, lay)


def gather_from_slabs(x: torch.Tensor, lay: SlabLayout) -> torch.Tensor:
    """The whole [B, N, H] tensor from every rank's [B, S, H] slab; the
    gradient of the slab is this rank's slab of the whole gradient."""
    return _GatherFromSlabs.apply(x, lay)


def slab_dropout(x: torch.Tensor, lay: SlabLayout, rate: float,
                 deterministic: bool, generator=None) -> torch.Tensor:
    """``ops.dropout.dropout`` of the slab ``x`` [B, S, H], its keep mask
    drawn at the whole [B, N, H] shape (the unpartitioned forward's draw)
    and cut to the slab."""
    if deterministic or rate <= 0.0:
        return x
    keep = bernoulli((x.shape[0], lay.n, *x.shape[2:]), 1.0 - rate,
                     generator, x.device)
    keep = lay.cut(keep, False)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


# ------------------------------------------------------------ the exchange
class ExchangeCounter:
    """Exchanges made (forward and backward) and the bytes that crossed
    from this rank to its peers (the buffer less its own chunk)."""

    def __init__(self):
        self.calls = 0
        self.bytes = 0

    def reset(self) -> None:
        self.calls = 0
        self.bytes = 0


EXCHANGES = ExchangeCounter()


def _all_to_all(sends: torch.Tensor, group) -> torch.Tensor:
    out = torch.empty_like(sends)
    dist.all_to_all_single(out, sends, group=group)
    return out


def _exchange(sends: torch.Tensor, group) -> torch.Tensor:
    sends = sends.contiguous()
    k = sends.shape[0]
    EXCHANGES.calls += 1
    EXCHANGES.bytes += sends.numel() * sends.element_size() * (k - 1) // k
    return _all_to_all(sends, group)


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sends, group):
        ctx.group = group
        return _exchange(sends, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def halo_exchange(sends: torch.Tensor, group,
                  debug_checksum: bool = False) -> torch.Tensor:
    """One ``all_to_all_single`` of a contiguous [K, ...] buffer over
    ``group``: chunk j of the result is what rank j sent this rank.  Its
    backward is the same exchange of the gradient.

    ``debug_checksum``: the sums of everything sent and of everything
    received over the group must agree (the exchange only permutes
    chunks); ``FloatingPointError`` if they do not.  It adds two
    all-reduces and a host sync."""
    recv = _HaloExchange.apply(sends, group)
    if debug_checksum:
        with torch.no_grad():
            sums = torch.stack([sends.float().sum(), recv.float().sum()])
            dist.all_reduce(sums, group=group)
        sent, got = sums.cpu().tolist()
        if not np.allclose(sent, got, rtol=1e-5, atol=1e-5):
            raise FloatingPointError(
                f"halo-exchange checksum mismatch: sent {sent!r} != "
                f"received {got!r}: boundary features were corrupted in "
                "transit")
    return recv


# ------------------------------------------------------------ aggregates
def _own(arrs: tuple, m: int) -> tuple:
    """Rank m's rows of one band's plan arrays: what each peer asks of it
    ([K, B, Hp]) and its own edge slots ([B, E*])."""
    return tuple(a[m] for a in arrs)


def _gather_sends(h_own, req, req_mask):
    """[K, B, Hp, H]: the rows of ``h_own`` [B, S, H] each peer asked for,
    zero in the unused slots."""
    k, b, hp = req.shape
    rows = gather_rows(h_own, req.permute(1, 0, 2).reshape(b, k * hp))
    rows = rows.reshape(b, k, hp, -1).permute(1, 0, 2, 3)
    return torch.where(req_mask[..., None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))


def _extended(h_own, halo_band):
    """Own slab ++ the received rows: [B, S + K·Hp, H], received row i
    from peer j at slot ``S + j·Hp + i``."""
    k, b, hp, h = halo_band.shape
    return torch.cat([h_own, halo_band.permute(1, 0, 2, 3).reshape(
        b, k * hp, h)], dim=1)


def _scatter(h_ext, dst, src, mask, slab: int):
    """``out[b, dst] += h_ext[b, src]`` over the masked slots; [B, S, H]."""
    msgs = gather_rows(h_ext, src)
    msgs = torch.where(mask[:, :, None], msgs,
                       torch.zeros((), dtype=msgs.dtype, device=msgs.device))
    return scatter_rows(msgs, dst, slab)


def _band(h_own, halo_band, ldst, lsrc, lmask, hdst, hsrc, hmask):
    slab = h_own.shape[1]
    out = _scatter(h_own, ldst, lsrc, lmask, slab)
    return out + _scatter(_extended(h_own, halo_band), hdst, hsrc, hmask,
                          slab)


def halo_aggregate(lay: SlabLayout, h, arrs: tuple,
                   debug_checksum: bool = False):
    """``A_f @ h`` (one band's plan ``arrs``, ``plans_from_batch`` order)
    on this rank's slab ``h`` [B, S, H], one exchange."""
    req, reqm, *edges = _own(arrs, lay.index)
    recv = halo_exchange(_gather_sends(h, req, reqm), lay.group,
                         debug_checksum)
    return _band(h, recv, *edges)


def halo_aggregate_pair(lay: SlabLayout, x_f, x_r, arrs_f: tuple,
                        arrs_r: tuple, debug_checksum: bool = False):
    """``A_f @ x_f + A_fᵀ @ x_r`` on this rank's slabs [B, S, H] with ONE
    exchange: both bands' requested rows in one [K, B, Hp_f + Hp_r, H]
    buffer, split back at Hp_f."""
    req_f, reqm_f, *edges_f = _own(arrs_f, lay.index)
    req_r, reqm_r, *edges_r = _own(arrs_r, lay.index)
    hp_f = req_f.shape[2]
    sends = torch.cat([_gather_sends(x_f, req_f, reqm_f),
                       _gather_sends(x_r, req_r, reqm_r)], dim=2)
    recv = halo_exchange(sends, lay.group, debug_checksum)
    return (_band(x_f, recv[:, :, :hp_f], *edges_f)
            + _band(x_r, recv[:, :, hp_f:], *edges_r))


def halo_attention_pair(lay: SlabLayout, q, kv, dk: int, arrs_f: tuple,
                        arrs_r: tuple, debug_checksum: bool = False):
    """Both attention bands on this rank's slab with ONE exchange of the
    boundary rows of ``kv = concat(k, messages)`` [B, S, Dk + H]; ``q``
    [B, S, Dk] comes scaled.  Every edge lives on its destination's rank,
    so the per-destination softmax is local: scores ``q[dst]·k[src]`` in
    f32, the max shift (no gradient) and the exp-sum by scatters over the
    slab, ``ops.sddmm.edge_softmax``'s -1e30 and 1e-30; the weights meet
    the messages in their dtype.  Returns the summed bands [B, S, H]."""
    req_f, reqm_f, *edges_f = _own(arrs_f, lay.index)
    req_r, reqm_r, *edges_r = _own(arrs_r, lay.index)
    hp_f = req_f.shape[2]
    sends = torch.cat([_gather_sends(kv, req_f, reqm_f),
                       _gather_sends(kv, req_r, reqm_r)], dim=2)
    recv = halo_exchange(sends, lay.group, debug_checksum)
    b, slab = q.shape[:2]
    neg = torch.full((), -1e30, dtype=torch.float32, device=q.device)
    zero = torch.zeros((), dtype=torch.float32, device=q.device)

    def band(halo_band, ldst, lsrc, lmask, hdst, hsrc, hmask):
        kv_ext = _extended(kv, halo_band)
        dst = torch.cat([ldst, hdst], dim=1)
        src = torch.cat([lsrc, hsrc], dim=1)
        msk = torch.cat([lmask, hmask], dim=1)
        di = dst.long()
        s = (gather_rows(q, dst).float()
             * gather_rows(kv_ext[..., :dk], src).float()).sum(-1)
        sm = torch.where(msk, s, neg)
        with torch.no_grad():
            mx = torch.full((b, slab), -1e30, dtype=torch.float32,
                            device=q.device).scatter_reduce(1, di, sm, "amax")
        ex = torch.where(msk, torch.exp(sm - torch.gather(mx, 1, di)), zero)
        den = torch.zeros((b, slab), dtype=torch.float32,
                          device=q.device).scatter_add(1, di, ex)
        alpha = ex / torch.gather(den, 1, di).clamp(min=1e-30)
        v = gather_rows(kv_ext[..., dk:], src)
        return scatter_rows(v * alpha[:, :, None].to(v.dtype), dst, slab)

    return (band(recv[:, :, :hp_f], *edges_f)
            + band(recv[:, :, hp_f:], *edges_r))
