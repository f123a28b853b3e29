"""The batched march: every ray advances in lock-step under masks
(counterpart of ``vxtpu/render/kernel_xla.py``, vxtpu's CLI default
``--kernel xla``).

Each ray carries a ``done`` flag; finished rays stop changing state while
the others step. The loop runs ``step_chunk`` steps between two checks of
whether every ray is done (each check is a host sync) and stops after
ceil(max_steps / step_chunk) chunks. Empty space is skipped with the
distance field (``march_xla_df``: one read a step answers both the hit
test and the jump radius) or with the occupancy pyramid (``march_xla``:
a ray whose coarse cell is empty jumps to that cell's exit).

Plain PyTorch tensor code, as vxtpu's is plain XLA: no hand-written
kernel (``world/grid.occupancy_at`` is vxtpu's ``_occ_fetch``). Float
operations keep vxtpu's order, so the two packages take the same cells;
each jump re-initialises the DDA at the jump's t and falls back to the
fine step when rounding leaves it in the same voxel.
"""

from __future__ import annotations

import functools

import torch

from vxtpu_torch.render import dda
from vxtpu_torch.render.dda import NEVER, safe_inverse
from vxtpu_torch.render.types import HitRecord
from vxtpu_torch.world.distfield import DistanceField, distfield_fetch
from vxtpu_torch.world.grid import in_bounds, occupancy_at
from vxtpu_torch.world.pyramid import OccupancyPyramid, pyramid_lookup

BIG_T = 1e30


def _axis_exit_t(o, d, inv_d, degenerate, lo, hi):
    """Per-axis t [N, 3] where the ray leaves the box [lo, hi] (float
    [N, 3] corners), through hi where d >= 0 and through lo otherwise;
    NEVER on axes the ray does not move along."""
    bound = torch.where(d >= 0, hi, lo)
    return torch.where(degenerate, NEVER, (bound - o) * inv_d)


def _coarse_exit(o, d, inv_d, degenerate, v, level_shift):
    """(t, axis mask [N, 3]) where the ray leaves the level cell (size
    2^level_shift) holding fine voxel v [N, 3]."""
    size = float(2 ** level_shift)
    c = (v >> level_shift).to(o.dtype)
    t_ax = _axis_exit_t(o, d, inv_d, degenerate, c * size, (c + 1.0) * size)
    return t_ax.amin(dim=-1), dda.dda_step_mask(t_ax)


def _start(o, d, dims, t_max, fetch, solid):
    """The set-up both marches share: clip, entry voxel, a hit in the
    entry voxel. fetch(v) reads the march's table at v, solid(value) says
    whether that is a hit. Returns (state, the entry voxel's value, t_end,
    t_delta, step)."""
    n = o.shape[0]
    if t_max is None:
        t_max = torch.full((n,), BIG_T, dtype=o.dtype, device=o.device)
    t_enter, t_exit, valid = dda.ray_grid_clip(o, d, dims)
    t_end = torch.minimum(t_exit, t_max)
    v0, t_next0, t_delta, step = dda.dda_init(o, d, t_enter, dims)
    read0 = fetch(v0)
    first_hit = valid & solid(read0) & (t_enter <= t_max)
    n0 = torch.where(dda.entry_face_mask(o, d, dims), -torch.sign(d),
                     0.0).to(torch.float32)
    state = dict(
        v=v0, t_next=t_next0, hit=first_hit,
        t_hit=torch.where(first_hit, t_enter, BIG_T),
        normal=torch.where(first_hit[..., None], n0, 0.0),
        steps=torch.zeros((n,), dtype=torch.int32, device=o.device),
        done=first_hit | ~valid)
    return state, read0, t_end, t_delta, step


def _finish(s, v_new, t_next_new, t_cross, mask, step, t_end, hit_now,
            dims):
    """Apply one step's candidate state to the active rays of s."""
    active = ~s["done"]
    inside = in_bounds(v_new, dims)
    past_end = t_cross > t_end
    new_hit = active & inside & ~past_end & hit_now
    a3 = active[..., None]
    s["v"] = torch.where(a3, v_new, s["v"])
    s["t_next"] = torch.where(a3, t_next_new, s["t_next"])
    s["hit"] = s["hit"] | new_hit
    s["t_hit"] = torch.where(new_hit, t_cross, s["t_hit"])
    s["normal"] = torch.where(new_hit[..., None], dda.face_normal(mask, step),
                              s["normal"])
    s["steps"] = s["steps"] + active.to(torch.int32)
    s["done"] = s["done"] | new_hit | (active & (~inside | past_end))
    return active


def _run_chunks(one_step, s, max_steps, step_chunk):
    """Chunks of step_chunk steps while some ray is not done, at most
    ceil(max_steps / step_chunk) of them. On the GPU the first step runs
    eagerly and every later one replays it from a CUDA graph: a step is
    ~60 small tensor ops, whose launches would cost more than their work."""
    def step():
        one_step(s)

    captured = not s["done"].is_cuda
    for _ in range(-(-max_steps // step_chunk)):
        if bool(s["done"].all()):
            break
        for _ in range(step_chunk):
            step()
            if not captured:
                step = capture_step(one_step, s).replay
                captured = True
    return HitRecord(hit=s["hit"], t=s["t_hit"], voxel=s["v"],
                     normal=s["normal"], steps=s["steps"])


def capture_step(one_step, s):
    """A CUDA graph of one step that reads the state tensors of s and
    writes the new state back into them (the same ops as the eager step;
    nothing runs until it is replayed). Captured on a side stream
    directly, without torch.cuda.graph's garbage collection and cache
    flush on every march."""
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graph.capture_begin()
        work = dict(s)
        one_step(work)
        for k, v in work.items():
            s[k].copy_(v)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    return graph


def march_xla(o: torch.Tensor, d: torch.Tensor, occ_flat: torch.Tensor,
              dims: tuple[int, int, int], max_steps: int,
              pyramid: OccupancyPyramid | None = None, step_chunk: int = 32,
              t_max: torch.Tensor | None = None) -> HitRecord:
    """March rays o, d [N, 3] over the flat occupancy; HitRecord [N].
    With a pyramid, a ray whose cell is empty at some level jumps to the
    exit of the coarsest such cell."""
    levels = pyramid.levels if pyramid is not None else ()
    s, _, t_end, t_delta, step = _start(
        o, d, dims, t_max, lambda v: occupancy_at(occ_flat, v, dims),
        lambda occ: occ > 0)
    inv_d = safe_inverse(d)
    degenerate = d.abs() < dda.EPS_DIR

    def one_step(s):
        v = s["v"]
        v_f, t_next_f, t_cross_f, mask_f = dda.dda_advance(
            v, s["t_next"], t_delta, step)
        if not levels:
            hit_now = occupancy_at(occ_flat, v_f, dims) > 0
            _finish(s, v_f, t_next_f, t_cross_f, mask_f, step, t_end,
                    hit_now, dims)
            return
        # the coarsest level whose cell holding v is empty (levels are
        # checked fine to coarse, so the last one that is empty wins)
        skip_shift = torch.zeros(v.shape[:1], dtype=torch.int32,
                                 device=v.device)
        for li in range(len(levels)):
            empty = ~pyramid_lookup(pyramid, li, v)
            skip_shift = torch.where(empty, li + 1, skip_shift)
        can_skip = skip_shift > 0
        t_skip, mask_s = t_cross_f, mask_f
        for li in range(len(levels)):
            t_li, m_li = _coarse_exit(o, d, inv_d, degenerate, v, li + 1)
            sel = skip_shift == li + 1
            t_skip = torch.where(sel, t_li, t_skip)
            mask_s = torch.where(sel[..., None], m_li, mask_s)
        v_s, t_next_s, _, _ = dda.dda_init(o, d, t_skip, dims)
        stuck = (v_s == v).all(dim=-1)
        do_skip = (can_skip & ~s["done"] & ~stuck)[..., None]
        v_new = torch.where(do_skip, v_s, v_f)
        t_next_new = torch.where(do_skip, t_next_s, t_next_f)
        t_cross = torch.where(do_skip[..., 0], t_skip, t_cross_f)
        mask = torch.where(do_skip, mask_s, mask_f)
        hit_now = occupancy_at(occ_flat, v_new, dims) > 0
        _finish(s, v_new, t_next_new, t_cross, mask, step, t_end, hit_now,
                dims)

    return _run_chunks(one_step, s, max_steps, step_chunk)


def march_xla_df(o: torch.Tensor, d: torch.Tensor, df_flat: torch.Tensor,
                 dims: tuple[int, int, int], max_steps: int,
                 step_chunk: int = 32,
                 t_max: torch.Tensor | None = None) -> HitRecord:
    """Distance-field march: one read a step gives the hit test (0 is
    solid) and the jump radius. Jumps cross only voxels the field proves
    empty, so hits equal the plain DDA's to float tolerance."""
    s, df0, t_end, t_delta, step = _start(
        o, d, dims, t_max, lambda v: distfield_fetch(df_flat, v, dims),
        lambda val: val == 0)
    s["dist"] = df0
    inv_d = safe_inverse(d)
    degenerate = d.abs() < dda.EPS_DIR

    def one_step(s):
        v, dist = s["v"], s["dist"]
        v_f, t_next_f, t_cross_f, mask_f = dda.dda_advance(
            v, s["t_next"], t_delta, step)
        # every voxel within L_inf distance dist - 1 of v is empty: jump
        # to the exit of the box [v - (dist - 1), v + dist]
        r = (dist.to(torch.int32) - 1).to(o.dtype)[..., None]
        vf = v.to(o.dtype)
        t_ax = _axis_exit_t(o, d, inv_d, degenerate, vf - r, vf + r + 1.0)
        t_jump = t_ax.amin(dim=-1)
        v_j, t_next_j, _, _ = dda.dda_init(o, d, t_jump, dims)
        stuck = (v_j == v).all(dim=-1)
        do_jump = (~s["done"] & (dist > 1) & ~stuck)[..., None]
        v_new = torch.where(do_jump, v_j, v_f)
        t_next_new = torch.where(do_jump, t_next_j, t_next_f)
        t_cross = torch.where(do_jump[..., 0], t_jump, t_cross_f)
        mask = torch.where(do_jump, dda.dda_step_mask(t_ax), mask_f)
        dfv = distfield_fetch(df_flat, v_new, dims)
        active = _finish(s, v_new, t_next_new, t_cross, mask, step, t_end,
                         dfv == 0, dims)
        s["dist"] = torch.where(active, dfv, dist)

    return _run_chunks(one_step, s, max_steps, step_chunk)


def make_march_xla(occ_flat, dims, settings, accel=None):
    """Pipeline march factory: ``march(o, d, t_max=None) -> HitRecord``.
    ``accel`` picks the empty-space skip: a DistanceField, an
    OccupancyPyramid (used when settings.pyramid_levels > 0), or None
    (plain fine DDA)."""
    max_steps = settings.resolve_max_steps(dims)
    if isinstance(accel, DistanceField):
        return functools.partial(march_xla_df, df_flat=accel.field.reshape(-1),
                                 dims=dims, max_steps=max_steps,
                                 step_chunk=settings.step_chunk)
    pyr = accel if (isinstance(accel, OccupancyPyramid)
                    and settings.pyramid_levels > 0) else None
    return functools.partial(march_xla, occ_flat=occ_flat, dims=dims,
                             max_steps=max_steps, pyramid=pyr,
                             step_chunk=settings.step_chunk)
