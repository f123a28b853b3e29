"""The wavefront march: the distance-field march with the rays still in
flight compacted into smaller buffers between rounds (counterpart of
``vxtpu/render/kernel_wavefront.py``, the CLI's ``--kernel wavefront``).

Each round r marches a buffer of B_r slots for at most K_r steps:

  round r:  pos   = cumsum(active) - 1          (full width)
            slots = the first B_r active rays   (a scatter of ray ids)
            march the B_r slots K_r steps       (B_r wide)
            scatter the slots' state back       (B_r wide)

A round whose buffer holds every ray marches the state in place. After
the schedule's rounds, drain rounds of ``drain_buf`` slots finish any ray
still in flight, so the result does not depend on the schedule.

A ray's state is three tensors: pack1 (int32: fresh, done and hit flags,
the hit axis and its step sign, the distance-field value and a 17-bit
step count), pack2 (int32: 10 bits per voxel axis) and t (float32). The
DDA's t_next is recomputed from the voxel when a ray enters a buffer;
the entry voxel is read inside the buffer (a "fresh" ray's first step
only reads it), so rays that miss the grid never read the table. The bit
layout and the shifts are vxtpu's, so a miss whose voxel stepped to -1
carries the same bits, and the same ``voxel`` and ``steps``, as there.

Plain PyTorch tensor code, as vxtpu's is plain XLA. On the GPU each
buffer size's step is captured once a march as a CUDA graph and replayed
(``kernel_xla.capture_step``); the compaction runs once a round, eagerly.
Whether a buffer is done is checked once every ``inner_chunk`` steps, and
whether any ray is left once a drain round (each check is a host sync).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vxtpu_torch.device import device_const
from vxtpu_torch.render import dda
from vxtpu_torch.render.dda import NEVER, safe_inverse
from vxtpu_torch.render.kernel_xla import capture_step
from vxtpu_torch.render.types import HitRecord
from vxtpu_torch.world.distfield import DistanceField, distfield_fetch
from vxtpu_torch.world.grid import in_bounds

BIG_T = 1e30

# pack1's bits
_FRESH = 1 << 0
_DONE = 1 << 1
_HIT = 1 << 2
_AX_SHIFT, _AX_MASK = 3, 0x3
_SG_BIT = 1 << 5                      # set: step sign +1 on the hit axis
_DIST_SHIFT, _DIST_MASK = 6, 0xFF
_STEP_SHIFT = 14                      # 17 bits of step count


def _round_up(x: int, m: int = 1024) -> int:
    return -(-x // m) * m


def _default_schedule(n: int, max_steps: int, valid_count: int | None = None):
    """(buffer, steps) of each round, sized for primary rays (many end
    early, a small tail runs long); the drain rounds make the result
    independent of it. Round 1 marches every ray in place for 8 steps;
    the later buffers follow vxtpu's measured survivor curve of the
    512^3/1080p primary rays (v/5 and v/40 of the v rays that meet the
    grid, ``count_valid_rays``; n when it is not given)."""
    v = n if valid_count is None else max(int(valid_count), 1)
    sched = [(n, min(8, max_steps))]
    if v >= 8192 and max_steps > 8:
        sched.append((min(max(1024, _round_up(v // 5)), n),
                      min(16, max_steps)))
    if v >= 32768 and max_steps > 24:
        sched.append((min(max(1024, _round_up(v // 40)), n),
                      min(40, max_steps)))
    return tuple(sched)


def count_valid_rays(o: torch.Tensor, d: torch.Tensor,
                     dims: tuple[int, int, int]) -> int:
    """The number of rays that meet the grid's box, as a host int (a host
    sync: call it outside a timed window; it sizes the schedule)."""
    _, _, valid = dda.ray_grid_clip(o, d, dims)
    return int(valid.sum())


def _pack_v(v: torch.Tensor) -> torch.Tensor:
    return (v[:, 0] << 20) | (v[:, 1] << 10) | v[:, 2]


def _unpack_v(p2: torch.Tensor) -> torch.Tensor:
    return torch.stack([(p2 >> 20) & 0x3FF, (p2 >> 10) & 0x3FF, p2 & 0x3FF],
                       dim=-1)


def _bit(cond: torch.Tensor, value) -> torch.Tensor:
    """int32 ``value`` where cond, 0 elsewhere (value a constant or an
    int32 tensor)."""
    return cond.to(torch.int32) * value


def _one_step(s: dict, c: dict, dims, max_steps: int, use_jumps: bool):
    """One step of every slot of the buffer: s holds its state (p1, v,
    t_next, t), c its constants (o, d, t_end, inv_d, t_delta, step,
    entry_mask, degenerate). Done slots keep their state."""
    p1, v, t_next, t = s["p1"], s["v"], s["t_next"], s["t"]
    o, d, inv_d = c["o"], c["d"], c["inv_d"]
    act = (p1 & _DONE) == 0
    fresh = (p1 & _FRESH) != 0
    dist = (p1 >> _DIST_SHIFT) & _DIST_MASK
    steps = p1 >> _STEP_SHIFT

    # the fine DDA step
    v_f, t_next_f, t_cross_f, mask_f = dda.dda_advance(v, t_next,
                                                       c["t_delta"],
                                                       c["step"])
    # the empty-space jump of march_xla_df
    r = (dist - 1).to(o.dtype)[..., None]
    vf = v.to(o.dtype)
    bound = torch.where(d >= 0, vf + r + 1.0, vf - r)
    t_ax = torch.where(c["degenerate"], NEVER, (bound - o) * inv_d)
    t_jump = t_ax.amin(dim=-1)
    mask_j = dda.dda_step_mask(t_ax)
    v_j, t_next_j, _, _ = dda.dda_init(o, d, t_jump, dims)
    stuck = (v_j == v).all(dim=-1)
    do_jump = (dist > 1) & ~stuck & ~fresh
    if not use_jumps:
        do_jump = torch.zeros_like(do_jump)
    j3 = do_jump[..., None]
    v_new = torch.where(j3, v_j, v_f)
    t_next_new = torch.where(j3, t_next_j, t_next_f)
    t_cross = torch.where(do_jump, t_jump, t_cross_f)
    mask = torch.where(j3, mask_j, mask_f)

    # a fresh ray only reads its current (entry) voxel
    f3 = fresh[..., None]
    v_new = torch.where(f3, v, v_new)
    t_next_new = torch.where(f3, t_next, t_next_new)
    t_cross = torch.where(fresh, t, t_cross)
    mask = torch.where(f3, c["entry_mask"], mask)

    inside = in_bounds(v_new, dims)
    past_end = t_cross > c["t_end"]
    dfv = distfield_fetch(c["df_flat"], v_new, dims).to(torch.int32)
    new_hit = act & inside & ~past_end & (dfv == 0)
    steps_new = steps + (act & ~fresh).to(torch.int32)
    newly_done = new_hit | (act & (~inside | past_end
                                   | (steps_new >= max_steps)))
    ax = torch.where(mask[..., 1], 1, torch.where(mask[..., 2], 2, 0)).to(
        torch.int32)
    # a step's or a jump's sign on its axis is step[ax]; so is the entry
    # face's normal sign, -sign(d)
    sg = torch.gather(c["step"], -1, ax[..., None].to(torch.int64))[..., 0]
    p1_new = (_bit(new_hit, _HIT) | _bit(newly_done, _DONE)
              | _bit(new_hit, (ax << _AX_SHIFT) | _bit(sg > 0, _SG_BIT))
              | (torch.clamp(dfv, 0, 255) << _DIST_SHIFT)
              | (steps_new << _STEP_SHIFT))
    a3 = act[..., None]
    s["p1"] = torch.where(act, p1_new, p1)
    s["v"] = torch.where(a3, v_new, v)
    s["t_next"] = torch.where(a3, t_next_new, t_next)
    s["t"] = torch.where(act, t_cross, t)


def _with_sink(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, x.new_zeros((1,))])


class _Rounds:
    """The march state of all n rays and the buffers of its rounds. pack1,
    pack2 and t_cur hold one more entry than there are rays: the sink
    that the scatters of dead slots write to (vxtpu's ``mode="drop"``)."""

    def __init__(self, o, d, t_end, df_flat, dims, max_steps, inner_chunk,
                 use_jumps, pack1, pack2, t_cur):
        self.o, self.d, self.t_end = o, d, t_end
        self.df_flat, self.dims = df_flat, dims
        self.max_steps, self.chunk = max_steps, inner_chunk
        self.use_jumps = use_jumps
        self.n = o.shape[0]
        self.pack1, self.pack2, self.t_cur = (_with_sink(pack1),
                                              _with_sink(pack2),
                                              _with_sink(t_cur))
        # buffer size -> (replay, the buffer's state and constants)
        self.graphs = {}
        self.syncs = 0          # host syncs: tests of whether a ray is left

    def _any_active(self, p1: torch.Tensor) -> bool:
        self.syncs += 1
        return bool(((p1 & _DONE) == 0).any())

    def any_active(self) -> bool:
        return self._any_active(self.pack1[:self.n])

    def _buffer(self, B: int):
        """(state, constants, live count, slot -> ray) of a round's buffer
        of B slots; slot -> ray is None when B covers every ray."""
        n = self.n
        pack1, pack2, t_cur = (self.pack1[:n], self.pack2[:n],
                               self.t_cur[:n])
        active = (pack1 & _DONE) == 0
        if B >= n:
            count = active.to(torch.int32).sum()
            p1, p2, tc = pack1.clone(), pack2, t_cur.clone()
            ob, db, teb, slot_ray = self.o, self.d, self.t_end, None
        else:
            pos = torch.cumsum(active.to(torch.int32), 0,
                               dtype=torch.int32) - 1
            sel = active & (pos < B)
            count = torch.clamp(active.to(torch.int32).sum(), max=B)
            ids = torch.arange(n, dtype=torch.int32, device=pack1.device)
            slot_ray = torch.zeros((B + 1,), dtype=torch.int32,
                                   device=pack1.device)
            slot_ray[torch.where(sel, pos, B).to(torch.int64)] = ids
            slot_ray = slot_ray[:B]
            live = torch.arange(B, dtype=torch.int32,
                                device=pack1.device) < count
            idx = slot_ray.to(torch.int64)
            p1, p2, tc = pack1[idx], pack2[idx], t_cur[idx]
            ob, db, teb = self.o[idx], self.d[idx], self.t_end[idx]
            # dead slots are done: they never read or write
            p1 = torch.where(live, p1, _DONE)
            slot_ray = torch.where(live, slot_ray, n)
        inv_d = safe_inverse(db)
        degenerate = db.abs() < dda.EPS_DIR
        vb = _unpack_v(p2)
        # the DDA invariant, a function of (v, o, d)
        nb = torch.where(db >= 0, vb.to(ob.dtype) + 1.0, vb.to(ob.dtype))
        t_next = torch.where(degenerate, NEVER, (nb - ob) * inv_d)
        c = dict(o=ob, d=db, t_end=teb, inv_d=inv_d, t_delta=inv_d.abs(),
                 step=torch.where(db >= 0, 1, -1).to(torch.int32),
                 entry_mask=dda.entry_face_mask(ob, db, self.dims),
                 degenerate=degenerate, df_flat=self.df_flat)
        s = dict(p1=p1, v=vb, t_next=t_next, t=tc)
        return s, c, count, slot_ray

    def run(self, B: int, K: int):
        """One round of B slots and at most K steps (in chunks of
        ``inner_chunk``, while a slot is active); (live count, chunks
        run)."""
        s, c, count, slot_ray = self._buffer(B)
        step = functools.partial(_one_step, dims=self.dims,
                                 max_steps=self.max_steps,
                                 use_jumps=self.use_jumps)
        replay = None
        if B in self.graphs:
            # the graph reads and writes its own tensors: load them
            replay, gs, gc = self.graphs[B]
            for src, dst in ((s, gs), (c, gc)):
                for k, x in src.items():
                    if dst[k].data_ptr() != x.data_ptr():
                        dst[k].copy_(x)
            s, c = gs, gc
        chunks = 0
        for _ in range(-(-K // self.chunk)):
            if not self._any_active(s["p1"]):
                break
            for _ in range(self.chunk):
                if replay is not None:
                    replay()
                    continue
                step(s, c)
                if s["p1"].is_cuda:
                    graph = capture_step(lambda st: step(st, c), s)
                    replay = graph.replay
                    self.graphs[B] = (replay, s, c)
            chunks += 1
        p2 = _pack_v(s["v"])
        n = self.n
        if slot_ray is None:
            self.pack1[:n], self.pack2[:n], self.t_cur[:n] = (s["p1"], p2,
                                                              s["t"])
        else:
            tgt = slot_ray.to(torch.int64)
            self.pack1[tgt] = s["p1"]
            self.pack2[tgt] = p2
            self.t_cur[tgt] = s["t"]
        return count, chunks


def march_wavefront(o: torch.Tensor, d: torch.Tensor, df_flat: torch.Tensor,
                    dims: tuple[int, int, int], max_steps: int,
                    t_max: torch.Tensor | None = None,
                    schedule: tuple[tuple[int, int], ...] | None = None,
                    drain_buf: int | None = None,
                    drain_steps: int = 24,
                    inner_chunk: int = 4,
                    use_jumps: bool = True,
                    valid_count: int | None = None,
                    stats: bool = False):
    """March rays o, d [N, 3] against the flat distance field; HitRecord
    [N], hit for hit equal to ``kernel_xla.march_xla_df``. ``schedule``:
    (buffer size, steps) of each round (``_default_schedule`` when None,
    sized by ``valid_count``); then rounds of ``drain_buf`` slots and
    ``drain_steps`` steps while a ray is in flight.

    stats=True also returns vxtpu's counters: per round the live slots
    (``round_counts``, tensors) and the steps run (``round_steps``), the
    drain rounds and their steps, and ``gathered_lanes`` = sum(B x steps
    run) (every slot reads the table every step), summed in float32 in
    vxtpu's order; and ``host_syncs``, the tests of whether a ray is left
    (one before each chunk and each drain round)."""
    n = o.shape[0]
    if max(dims) > 1024:
        raise ValueError("the wavefront march packs 10 bits per voxel axis")
    if schedule is None:
        schedule = _default_schedule(n, max_steps, valid_count)
    if drain_buf is None:
        drain_buf = max(2048, n // 32)
    drain_buf = min(drain_buf, n)
    if t_max is None:
        t_max = torch.full((n,), BIG_T, dtype=o.dtype, device=o.device)

    # the full-width set-up: elementwise, no table reads
    t_enter, t_exit, valid = dda.ray_grid_clip(o, d, dims)
    t_end = torch.minimum(t_exit, t_max)
    valid = valid & (t_enter <= t_end)
    v0, _, _, _ = dda.dda_init(o, d, t_enter, dims)
    pack1 = torch.where(valid, _FRESH, _DONE).to(torch.int32)
    rounds = _Rounds(o, d, t_end, df_flat, dims, max_steps, inner_chunk,
                     use_jumps, pack1, _pack_v(v0), t_enter)

    round_counts, round_steps = [], []
    for B, K in schedule:
        cnt, chunks = rounds.run(int(B), int(K))
        round_counts.append(cnt)
        round_steps.append(chunks * inner_chunk)

    # the drain: the result does not depend on the schedule
    max_rounds = (-(-n // drain_buf) * (-(-max_steps // max(drain_steps, 1))
                                        + 1) + 4)
    drain_rounds = drain_steps_total = 0
    while drain_rounds < max_rounds and rounds.any_active():
        _, chunks = rounds.run(drain_buf, drain_steps)
        drain_rounds += 1
        drain_steps_total += chunks * inner_chunk

    pack1, pack2 = rounds.pack1[:n], rounds.pack2[:n]
    hit = (pack1 & _HIT) != 0
    ax = (pack1 >> _AX_SHIFT) & _AX_MASK
    sg = torch.where((pack1 & _SG_BIT) != 0, 1.0, -1.0)
    one_hot = ax[:, None] == device_const((0, 1, 2), ax.dtype, ax.device)
    normal = -sg[:, None] * one_hot.to(torch.float32)
    rec = HitRecord(
        hit=hit,
        t=torch.where(hit, rounds.t_cur[:n], BIG_T),
        voxel=_unpack_v(pack2),
        normal=torch.where(hit[:, None], normal, 0.0),
        steps=pack1 >> _STEP_SHIFT)
    if not stats:
        return rec
    # float32 as vxtpu sums it: n * max_steps lanes overflow int32
    f32 = np.float32
    lanes = f32(0)
    for (B, _), s in zip(schedule, round_steps):
        lanes = f32(lanes + f32(B) * f32(s))
    lanes = f32(lanes + f32(drain_buf) * f32(drain_steps_total))
    return rec, dict(
        n_rays=n, valid=valid.to(torch.int32).sum(),
        schedule=tuple(schedule), round_counts=round_counts,
        round_steps=round_steps, drain_buf=drain_buf,
        drain_rounds=drain_rounds, drain_steps_total=drain_steps_total,
        gathered_lanes=float(lanes),
        total_rounds=len(schedule) + drain_rounds, host_syncs=rounds.syncs)


def make_march_wavefront(occ_flat, dims, settings, accel=None, schedule=None,
                         valid_count=None):
    """Pipeline march factory: ``march(o, d, t_max=None) -> HitRecord``.
    ``accel`` is the DistanceField to march; any other kind makes the
    factory build a cap-96 field from the grid (at 512^3 that is 95
    dilation passes: set-up, to be kept out of a timed window).
    ``valid_count`` (``count_valid_rays``) sizes the default schedule to
    the scene."""
    if not isinstance(accel, DistanceField):
        from vxtpu_torch.world import distfield

        accel = distfield.build(occ_flat.reshape(dims), cap=96)
    return functools.partial(
        march_wavefront, df_flat=accel.field.reshape(-1), dims=dims,
        max_steps=settings.resolve_max_steps(dims), schedule=schedule,
        valid_count=valid_count)
