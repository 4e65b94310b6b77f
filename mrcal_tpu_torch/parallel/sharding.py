"""Observation-sharded bundle adjustment over a torch.distributed group.

Counterpart of ``mrcal_tpu/parallel/sharding.py``:

  - the observation axis (board observations, point observations and
    triangulated pairs) is cut into one contiguous shard per rank, all of
    one length: the tail is padded with observations of weight -1, whose
    residual rows and Jacobians are exactly zero;
  - each rank assembles the LOCAL normal-equation blocks of its shard with
    the single-device assembly (``build_normal_equations``), without the
    regularization;
  - the blocks are all-reduced, one flat buffer per dtype, and the
    regularization is added once, after the reduce;
  - the Schur step (the batched-Cholesky kernel) and the LM rules run
    replicated on every rank, in the single-device loop (``_lm_loop``).
    Every rank holds the same reduced E, so every rank reads the same
    accept and stop flags and the ranks stay in step;
  - the residual rows stay on their ranks through the loop and are
    gathered once, at the end of a solve, for outlier rejection.

Every rank runs the same program on the whole problem's inputs (SPMD):
``optimize(mesh=...)`` is called on each rank after
``torch.distributed.init_process_group``.  Without a process group a mesh
of one runs the same code with collectives that are the identity.
"""

import os
import tempfile
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from ..optimize.layout import ProblemSpec, triangulated_pair_indices
from ..optimize.solver import (_CLayout, _STEP_KEYS, _cast_arrays,
                               _delta_to_b, _lazy_h_K, _lm_loop,
                               build_normal_equations, schur_step)

# the normal-equation blocks that are reduced over the mesh
BLOCK_KEYS = ("E",) + _STEP_KEYS
# the residual rows that stay on their ranks until a solve ends
_ROW_KEYS = ("x_board", "x_point", "x_tri")
# padding pairs' two rays: any non-degenerate geometry (v0 == v1 would
# give NaN before the weight masks the pair)
_PAD_RAYS = ((0.0, 0.0, 1.0), (0.1, 0.0, 1.0))


class Mesh:
    """The ranks a solve is sharded over: the process group (None: a mesh
    of one, whose collectives are the identity), this process's rank, the
    number of ranks, the rank's device and the axis name.  `counts`
    tallies the collectives issued through it and the normal-equation
    evaluations, and `bytes_reduced` the bytes all-reduced."""

    def __init__(self, group, rank, size, device, axis="obs"):
        self.group = group
        self.rank = rank
        self.size = size
        self.device = torch.device(device)
        self.axis = axis
        self.reset_counts()

    def reset_counts(self):
        self.counts = dict(all_reduce=0, all_gather=0, normal_equations=0,
                           gradients=0)
        self.bytes_reduced = 0

    def __repr__(self):
        backend = None if self.group is None else dist.get_backend(self.group)
        return (f"Mesh(rank={self.rank}, size={self.size}, "
                f"device={self.device}, backend={backend}, "
                f"axis={self.axis!r})")

    def all_reduce(self, flat):
        """Sum flat over the ranks, in place."""
        self.counts["all_reduce"] += 1
        self.bytes_reduced += flat.numel() * flat.element_size()
        if self.group is not None:
            dist.all_reduce(flat, group=self.group)
        return flat

    def all_gather(self, flat):
        """Every rank's flat (all of one length), in rank order: (size,
        n).  gloo gathers host tensors: a card's goes through the host."""
        self.counts["all_gather"] += 1
        if self.group is None:
            return flat[None]
        src = flat
        if flat.is_cuda and dist.get_backend(self.group) == "gloo":
            src = flat.cpu()
        out = src.new_empty(self.size * src.numel())
        dist.all_gather_into_tensor(out, src, group=self.group)
        return out.view(self.size, -1).to(flat.device)


def make_mesh(n_devices=None, axis="obs", *, device=None):
    """The mesh of the default process group.  n_devices (None or "auto":
    the group's world size) must equal the world size.  With no group
    initialized, make_mesh(1) is a mesh of one.

    device: the rank's device; None means cuda:(LOCAL_RANK % the number
    of cards), LOCAL_RANK defaulting to the rank, and raises without a
    card.  Only an explicit device="cpu" puts the rank on the CPU."""
    if isinstance(n_devices, str) and n_devices != "auto":
        raise ValueError(f"make_mesh({n_devices!r}): expected an int or "
                         "'auto'")
    n = None if n_devices in (None, "auto") else int(n_devices)
    if dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
        rank, size = dist.get_rank(), dist.get_world_size()
        if n is not None and n != size:
            raise ValueError(f"make_mesh({n}): the process group has "
                             f"{size} ranks")
    else:
        if n not in (None, 1):
            raise RuntimeError(
                f"make_mesh({n}) needs torch.distributed initialized with "
                f"{n} ranks (init_process_group) on every rank")
        group, rank, size = None, 0, 1
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU explicitly")
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
    return Mesh(group, rank, size, device, axis)


def _pad_to(n, k):
    return (n + k - 1) // k * k


def _shard_rows(a, pad_row, rank, L):
    """Rows [rank*L, (rank+1)*L) of a, with pad_row past its end."""
    lo = min(rank * L, len(a))
    hi = min((rank + 1) * L, len(a))
    pad = pad_row.expand((L - (hi - lo),) + a.shape[1:])
    return torch.cat([a[lo:hi], pad.to(a.dtype)], dim=0)


def _padded_shard_arrays(spec: ProblemSpec, arrays, mesh):
    """This rank's shard of the observation arrays (on their device) and
    the host index arrays its assembly needs: (shard arrays, static_idx,
    lengths).  Each kind of observation is cut into mesh.size contiguous
    shards of one length, its count padded to a multiple of the size;
    padding observations have weight -1 and a real observation's indices.
    Triangulated pairs are gathered first, so the pair axis shards: a
    shard's triangulated observations are its pairs' first observations,
    then their second ones.  lengths: each kind's shard length and total
    count."""
    size, rank = mesh.size, mesh.rank
    sh = dict(arrays)
    lengths = {}

    def obs_pad(obs):
        pad = obs.new_zeros((1,) + obs.shape[1:])
        pad[..., 2] = -1.0
        return pad

    for key_o, key_i, n in (
            ("observations_board", "indices_board",
             spec.Nobservations_board),
            ("observations_point", "indices_point",
             spec.Nobservations_point)):
        L = _pad_to(n, size) // size
        lengths[key_o] = (L, n)
        if n:
            sh[key_o] = _shard_rows(arrays[key_o], obs_pad(arrays[key_o]),
                                    rank, L)
            sh[key_i] = _shard_rows(arrays[key_i], arrays[key_i][:1],
                                    rank, L)
    static_idx = dict(board=sh["indices_board"].cpu().numpy(),
                      point=sh["indices_point"].cpu().numpy())

    Ntp = spec.num_measurements_points_triangulated
    L = _pad_to(Ntp, size) // size
    lengths["pairs"] = (L, Ntp)
    if Ntp:
        i0, i1 = (torch.as_tensor(i, device=arrays["intrinsics"].device)
                  for i in triangulated_pair_indices(
                      spec.triangulated_set_sizes))
        obs = arrays["observations_point_triangulated"]
        idx = arrays["indices_triangulated"]
        px = arrays["px_triangulated"]
        parts = {k: [] for k in ("obs", "idx", "px")}
        for ends, ray in zip((i0, i1), _PAD_RAYS):
            parts["obs"].append(_shard_rows(obs[ends], obs_pad(obs), rank,
                                            L))
            parts["idx"].append(_shard_rows(idx[ends], idx[:1], rank, L))
            parts["px"].append(_shard_rows(px[ends], px.new_tensor([ray]),
                                           rank, L))
        sh["observations_point_triangulated"] = torch.cat(parts["obs"])
        sh["indices_triangulated"] = torch.cat(parts["idx"])
        sh["px_triangulated"] = torch.cat(parts["px"])
        static_idx["pairs"] = (np.arange(L), L + np.arange(L))
    return sh, static_idx, lengths


class _ShardedProblem:
    """The sharded normal equations of one problem on one rank: ne(b) and
    gradient(b) reduced over the mesh, with the regularization added once,
    and the residual rows of this rank's shard; gathered(ne) puts the
    whole problem's rows into ne."""

    def __init__(self, spec: ProblemSpec, arrays, mesh, h32=False):
        self.spec = spec
        self.mesh = mesh
        self.arrays, static_idx, self.lengths = _padded_shard_arrays(
            spec, arrays, mesh)
        self.local = build_normal_equations(spec, self.arrays, static_idx,
                                            h32=h32, regularization=False)

    def _reduce(self, ne, keys):
        """All-reduce ne's `keys`: one flat buffer per dtype, one call
        each; the reduced entries are views of the buffers."""
        out = dict(ne)
        for dt in dict.fromkeys(ne[k].dtype for k in keys):
            ks = [k for k in keys if ne[k].dtype == dt]
            flat = self.mesh.all_reduce(
                torch.cat([ne[k].reshape(-1) for k in ks]))
            for k, v in zip(ks, flat.split([ne[k].numel() for k in ks])):
                out[k] = v.view(ne[k].shape)
        return out

    def ne(self, b):
        self.mesh.counts["normal_equations"] += 1
        ne = self._reduce(self.local(b, self.arrays), BLOCK_KEYS)
        return self.local.add_regularization(b, self.arrays, ne)

    def gradient(self, b):
        """E, the gradient and the residual rows (the lazy-Hessian mode's
        evaluation), reduced over the mesh with the regularization added
        once: the spline-window assembly's gradient-only mode, or else
        the whole normal equations."""
        if not hasattr(self.local, "gradient"):
            return self.ne(b)
        self.mesh.counts["gradients"] += 1
        ne = self._reduce(self.local.gradient(b, self.arrays),
                          ("E", "g_c", "g_f", "g_p"))
        return self.local.add_regularization(b, self.arrays, ne,
                                             hessian=False)

    def gathered(self, ne):
        """ne with the whole problem's residual rows, in the unsharded
        order and without padding (every rank gets them all)."""
        spec = self.spec
        widths = dict(x_board=2 * spec.calibration_object_height_n *
                      spec.calibration_object_width_n
                      if spec.Nobservations_board else 0,
                      x_point=2, x_tri=1)
        kinds = dict(x_board="observations_board",
                     x_point="observations_point", x_tri="pairs")
        local = [ne[k].reshape(-1) for k in _ROW_KEYS]
        rows = self.mesh.all_gather(torch.cat(local))        # (size, n)
        out = dict(ne)
        for k, v in zip(_ROW_KEYS, rows.split([t.numel() for t in local],
                                               dim=1)):
            n = self.lengths[kinds[k]][1]
            out[k] = v.reshape(-1)[:n * widths[k]]
        return out


def sharded_normal_equations(spec: ProblemSpec, mesh):
    """make(arrays) -> fn(b): the normal-equation blocks (BLOCK_KEYS) of
    the whole problem at the packed state b, assembled from this rank's
    shard of `arrays`, all-reduced over the mesh, with the regularization
    added once."""
    def make(arrays):
        problem = _ShardedProblem(spec, arrays, mesh)

        def fn(b):
            ne = problem.ne(b)
            return {k: ne[k] for k in BLOCK_KEYS}

        return fn

    return make


def sharded_lm_step(spec: ProblemSpec, mesh):
    """make(arrays) -> step(b, lam) -> (b + db, E, pred, db): one LM step
    over the mesh, the normal equations sharded and the Schur step
    replicated."""
    def make(arrays):
        problem = _ShardedProblem(spec, arrays, mesh)

        def step(b, lam):
            with torch.no_grad():
                ne = problem.ne(b)
                dc, df, dp, pred = schur_step(ne, lam, spec)
                db = _delta_to_b(dc, df, dp, spec)
            return b + db, ne["E"], pred, db

        return step

    return make


def collective_bytes_per_iteration(spec: ProblemSpec, dtype=np.float64,
                                   h32=False):
    """Bytes all-reduced over the mesh per LM iteration (one evaluation of
    the normal equations): the blocks, never the Jacobian or the residual
    rows.  h32: the splined window assembly's float32-H solve, whose H/C
    blocks ride in float32 and its gradients in dtype (the JAX package's
    splined float64 solve always does this; the port's only when asked).
    Returns (total_bytes, breakdown dict)."""
    cl = _CLayout(spec)
    Nc = cl.Nc
    Nf = max(spec.Nframes, 1)
    Npv = max(spec.Npoints_variable, 1)
    itemsize = np.dtype(dtype).itemsize
    h_itemsize = 4 if (h32 and spec.is_splined) else itemsize
    breakdown = dict(
        E=1, g_c=Nc, g_f=Nf * 6, g_p=Npv * 3,
        Hcc=Nc * Nc, Hff=Nf * 36, Cf=Nf * 6 * Nc,
        Hpp=Npv * 9, Cp=Npv * 3 * Nc)
    nbytes = {k: v * (h_itemsize if k[0] in "HC" else itemsize)
              for k, v in breakdown.items()}
    return sum(nbytes.values()), nbytes


def sharded_lm_solve_device(spec: ProblemSpec, arrays, b0, mesh,
                            max_iterations=300, update_threshold=1e-7,
                            dtype=None, quiet=False, lam0=1e-4, ftol=None,
                            lazy_K=None, h32=False):
    """The multi-device solve: the single-device LM loop (_lm_loop: gain
    ratio, windowed ftol plateau, lazy Hessian) with the normal equations
    sharded over the mesh's ranks, one all-reduce per dtype per
    evaluation, and the Schur step replicated.  arrays and b0 are the
    whole problem's, on the rank's device; every rank passes the same.

    Returns (b, E, niter, ne) as lm_solve: E a 0-d tensor, ne the reduced
    blocks and the whole problem's residual vectors, unpadded (gathered
    once, at the end), so optimize()'s outlier loop and precision modes
    run unchanged."""
    if dtype is not None:
        arrays = _cast_arrays(arrays, dtype)
        b0 = b0.to(dtype)
    if lazy_K is None:
        lazy_K = _lazy_h_K(spec, b0.dtype, b0.device)
    problem = _ShardedProblem(spec, arrays, mesh, h32=h32)
    b, E, niter, ne = _lm_loop(
        spec, problem.ne, problem.gradient, b0,
        max_iterations=max_iterations, update_threshold=update_threshold,
        quiet=quiet, lam0=lam0, ftol=ftol, lazy_K=lazy_K)
    return b, E, niter, problem.gathered(ne)


def sharded_lm_solve(spec: ProblemSpec, arrays, b0, mesh,
                     max_iterations=50, update_threshold=1e-7):
    """LM to convergence with observation sharding -> (b, E): the legacy
    entry point of the JAX package, here the same loop as
    sharded_lm_solve_device (the port has one set of LM rules)."""
    b, E, _, _ = sharded_lm_solve_device(
        spec, arrays, b0, mesh, max_iterations=max_iterations,
        update_threshold=update_threshold, lazy_K=0)
    return b, E


# ----------------------------------------------------------------------------
# processes: one rank each
# ----------------------------------------------------------------------------

def _rank_main(rank, fn, world_size, backend, device, workdir, args):
    """A spawned rank: join the group, run fn(mesh, *args), save its
    result for the parent, leave the group."""
    if device is None:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    elif torch.device(device).type == "cpu":
        # small CPU ranks share the host's cores with their siblings
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{workdir}/store",
                            rank=rank, world_size=world_size,
                            timeout=timedelta(seconds=300))
    try:
        result = fn(make_mesh(world_size, device=device), *args)
        torch.save(result, os.path.join(workdir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn, world_size, *args, device=None):
    """Run fn(mesh, *args) on world_size new processes, one rank each,
    joined by a process group (a file store in a temporary directory; no
    network), and return each rank's result in rank order.  fn must be
    importable by name (a module-level function), and its result
    picklable.

    device: each rank's device; None means cuda:(rank % the number of
    cards), and raises without a card; "cpu" the CPU.  The ranks join over
    NCCL when each has a card of its own, else over gloo (ranks sharing a
    card, or on the CPU).  A failure in any rank raises here, and the
    other ranks are stopped."""
    import torch.multiprocessing as mp
    if device is None and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the ranks on the CPU explicitly")
    backend = ("nccl" if device is None
               and torch.cuda.device_count() >= world_size else "gloo")
    with tempfile.TemporaryDirectory() as workdir:
        mp.start_processes(_rank_main, nprocs=world_size,
                           args=(fn, world_size, backend, device, workdir,
                                 args),
                           join=True, start_method="spawn")
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                           weights_only=False) for r in range(world_size)]


def _dryrun_rank(mesh):
    """dryrun_multichip's rank: an OPENCV8 problem and a 9x7-knot splined
    one, 3 iterations each over the mesh."""
    from .. import problems
    out = {}
    for name, mk in (
            ("opencv8", dict(Ncameras=2, Nframes=max(4, mesh.size), W=4,
                             H=3)),
            ("splined", dict(
                Ncameras=1, Nframes=max(4, mesh.size), W=5, H=4,
                model="LENSMODEL_SPLINED_STEREOGRAPHIC_order=3_Nx=9_Ny=7"
                      "_fov_x_deg=120",
                do_optimize_intrinsics_core=False))):
        _, spec, arrays, b0 = problems.make_problem(device=mesh.device, **mk)
        b, E, niter, _ = sharded_lm_solve_device(spec, arrays, b0, mesh,
                                                 max_iterations=3)
        if not (niter >= 1 and torch.isfinite(E)
                and bool(torch.isfinite(b).all())):
            raise RuntimeError(f"dryrun {name}: {niter} iterations, E {E}")
        out[name] = dict(niterations=niter, E=float(E))
    return out


def dryrun_multichip(n_devices, device=None):
    """Validate the multi-device path: n_devices ranks each solve an
    OPENCV8 problem (2 cameras, a 4x3 board) and a 9x7-knot splined one
    for 3 iterations over the mesh, and check that E and b are finite.
    device as spawn's: by default the ranks run on the cards (NCCL with a
    card each, else gloo with the cards shared); "cpu" runs them on the
    CPU over gloo.  Returns rank 0's {problem: dict(niterations, E)}."""
    return spawn(_dryrun_rank, n_devices, device=device)[0]
