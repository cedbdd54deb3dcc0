"""Ranks of the port's multi-process tests, and the launcher that spawns
them (``tests/test_torch_parallel.py``, ``tests/test_torch_multihost.py``,
``tests/test_torch_parallel_card.py``).

``run_world(n, mode, workdir)`` (``start_world`` then ``wait_world``)
starts ``n`` processes of this file, each configured as
``tests/test_multihost.py`` configures its workers (the
``PPSFM_COORDINATOR``, ``PPSFM_NUM_PROCESSES`` and ``PPSFM_PROCESS_ID``
environment variables, a free local port), waits for all of them at most
``timeout`` seconds, kills every rank past it and fails. Each rank runs
with one torch thread in a gloo world on the CPU (or on one card: several
ranks share it through gloo, one rank alone takes NCCL), reads its inputs
from ``workdir/inputs.npz`` and writes ``workdir/<mode>_<rank>.npz``.
Nothing here imports JAX: the test process computes the reference's side.

Modes:
  ``solve``: ``bundle_adjust_sharded`` on every problem of the inputs, the
  sharded matcher on every pair list, and (in a world of one rank)
  ``ba.bundle_adjust`` on the same problems with the same threads;
  ``multihost``: the sharded solve against the single-process solve in
  each rank, ``MULTIHOST_OK`` on success;
  ``hang``: rank 0 waits in an all-reduce that rank 1 never joins.
"""

import os
import random
import socket
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BA_FIELDS = ("qvecs", "tvecs", "cam_params", "points3d", "obs_cam",
             "obs_point", "obs_line", "obs_weight", "cam_dof_mask",
             "point_mask")


def free_port() -> int:
    """A local port free now, drawn below Linux's ephemeral range (32768
    and up), from which outgoing connections (the ranks' own among them)
    take ports while rank 0 is still starting."""
    rng = random.Random()
    while True:
        port = rng.randrange(20000, 32000)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        return port


def start_world(n: int, mode: str, workdir: str, timeout: float = 120.0,
                device: str = "cpu"):
    """Start ``n`` ranks of ``mode`` on ``device``; ``wait_world`` of the
    result waits for them, at most ``timeout`` seconds from now."""
    port = free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, PPSFM_COORDINATOR=f"127.0.0.1:{port}",
                   PPSFM_NUM_PROCESSES=str(n), PPSFM_PROCESS_ID=str(rank),
                   PYTHONPATH=os.pathsep.join([ROOT, HERE]),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), mode, workdir,
             device],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    return procs, mode, time.monotonic() + timeout


def wait_world(world):
    """The outputs of a ``start_world`` world.  Raises ``AssertionError``
    when a rank fails or when the world outlives its timeout (every rank
    is killed first)."""
    procs, mode, deadline = world
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(
                timeout=max(0.1, deadline - time.monotonic()))
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise AssertionError(f"{mode}: the world of {len(procs)} ranks "
                             "did not end in time; every rank was killed")
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{mode} rank {rank} failed:\n{out}"
    return outs


def run_world(n: int, mode: str, workdir: str, timeout: float = 120.0,
              device: str = "cpu"):
    """``start_world`` and ``wait_world``: the outputs of ``n`` ranks of
    ``mode`` on ``device``."""
    return wait_world(start_world(n, mode, workdir, timeout, device))


def load_problem(inputs, name, torch, device="cpu"):
    from privacy_preserving_sfm_torch.optim import ba

    return ba.BAProblem(*(torch.from_numpy(inputs[f"{name}.{f}"]).to(device)
                          for f in BA_FIELDS))


def host(x):
    return x.cpu().numpy()


def problem_names(inputs):
    return sorted({k.split(".")[0] for k in inputs.files if "." in k})


def solve(inputs, rank, world, torch, group, device):
    import torch.distributed as dist

    from privacy_preserving_sfm_torch.features import matching
    from privacy_preserving_sfm_torch.optim import ba
    from privacy_preserving_sfm_torch.parallel import (
        distributed_ba, multihost, sharded_matching,
    )

    out = {}
    for name in problem_names(inputs):
        problem = load_problem(inputs, name, torch, device)
        sharded, meta = distributed_ba.shard_problem(problem, world)
        local = multihost.make_global_problem(sharded, meta, group, device)
        reducer = distributed_ba.Reducer(group)
        q, t, X, s = distributed_ba.bundle_adjust_sharded(
            local, group, "SIMPLE_PINHOLE", reducer=reducer)
        out.update({f"{name}.q": host(q), f"{name}.t": host(t),
                    f"{name}.X": host(X),
                    f"{name}.X_all": host(multihost.gather_points(X, group)),
                    f"{name}.summary": np.asarray(s, np.float64),
                    f"{name}.calls": np.asarray(reducer.calls)})
        if world == 1:
            q1, t1, X1, s1 = ba.bundle_adjust(problem, "SIMPLE_PINHOLE")
            out.update({f"{name}.ref_q": host(q1), f"{name}.ref_t": host(t1),
                        f"{name}.ref_X": host(X1),
                        f"{name}.ref_summary": np.asarray(s1, np.float64)})
    if world > 2:  # a group of the first two ranks
        sub = distributed_ba.make_mesh(2)
        if rank < 2:
            one = torch.ones(1, device=device)
            dist.all_reduce(one, group=sub)
            out["sub"] = np.asarray([dist.get_world_size(sub), int(one)])
    desc = torch.from_numpy(inputs["desc"]).to(device)
    valid = torch.from_numpy(inputs["valid"]).to(device)
    for key in [k for k in inputs.files if k.startswith("pairs")]:
        pairs = torch.from_numpy(inputs[key]).to(device)
        res = sharded_matching.match_pairs_sharded(desc, valid, pairs, group)
        every = sharded_matching.gather_rows(res, group)
        full = matching.match_many_pairs(desc, valid, pairs)
        for f in matching.MatchResult._fields:
            out[f"{key}.{f}"] = host(getattr(every, f))
            out[f"{key}.local_{f}"] = host(getattr(res, f))
            out[f"{key}.full_{f}"] = host(getattr(full, f))
    return out


def multihost_check(inputs, rank, world, torch, group, device):
    from privacy_preserving_sfm_torch.optim import ba
    from privacy_preserving_sfm_torch.parallel import (
        distributed_ba, multihost,
    )

    out = {}
    for name in problem_names(inputs):
        problem = load_problem(inputs, name, torch)
        q1, t1, X1, s1 = ba.bundle_adjust(problem, "SIMPLE_PINHOLE")
        sharded, meta = distributed_ba.shard_problem(problem, world)
        local = multihost.make_global_problem(
            sharded, meta, multihost.global_mesh(), device)
        q, t, X, s = distributed_ba.bundle_adjust_sharded(
            local, group, "SIMPLE_PINHOLE")
        X_all = multihost.gather_points(X, group).numpy().reshape(
            world, meta["points_per_shard"], 3)
        X_all = X_all[meta["point_shard"], meta["point_slot"]]
        for got, want in ((q, q1), (t, t1)):
            assert np.allclose(got.numpy(), want.numpy(), atol=1e-6,
                               rtol=0), np.abs(got.numpy() - want.numpy())
        assert np.allclose(X_all, X1.numpy(), atol=1e-6, rtol=0), \
            np.abs(X_all - X1.numpy()).max()
        assert abs(s.final_cost - s1.final_cost) <= \
            1e-8 * max(s1.final_cost, 1e-10), (s, s1)
        out[f"{name}.cost"] = np.asarray(s.final_cost)
    print(f"MULTIHOST_OK process={rank} world={world}", flush=True)
    return out


def random_problem(seed: int, num_cams: int, num_points: int, noise: float,
                   dtype=np.float32) -> dict:
    """A BA problem with numpy alone, as ``tests/test_ba.py``'s
    ``make_ba_problem`` builds it (cameras about a point cloud 6 units
    ahead, every point seen by every camera, camera 0 and camera 1's t_x
    frozen), the poses and points perturbed and the lines noised; its
    fields by ``BA_FIELDS`` name."""
    from privacy_preserving_sfm_torch.ops import lie_np

    rng = np.random.default_rng(seed)
    C, P = num_cams, num_points
    yaw = rng.uniform(-0.4, 0.4, C)
    qs = np.stack([np.cos(yaw / 2), np.zeros(C), np.sin(yaw / 2),
                   np.zeros(C)], 1)
    ts = rng.uniform(-1, 1, (C, 3))
    pts = rng.uniform(-2, 2, (P, 3)) + [0.0, 0.0, 6.0]
    lines = []
    for c in range(C):
        R = lie_np.quat_to_rotmat(qs[c])
        Xc = pts @ R.T + ts[c]
        hom = np.concatenate([Xc[:, :2] / Xc[:, 2:], np.ones((P, 1))], 1)
        ls = np.cross(rng.standard_normal((P, 3)), hom)
        lines.append(ls / np.linalg.norm(ls[:, :2], axis=-1, keepdims=True))
    lines = np.concatenate(lines) + rng.normal(0, noise, (C * P, 3))
    lines /= np.linalg.norm(lines[:, :2], axis=-1, keepdims=True)
    mask = np.ones((C, 6))
    mask[0] = 0.0
    mask[1, 3] = 0.0
    fields = dict(
        qvecs=qs + rng.normal(0, 0.01, (C, 4)) * (np.arange(C) > 0)[:, None],
        tvecs=ts + rng.normal(0, 0.02, (C, 3)) * mask[:, 3:],
        cam_params=np.tile([500.0, 320.0, 240.0], (C, 1)),
        points3d=pts + rng.normal(0, 0.02, (P, 3)),
        obs_cam=np.repeat(np.arange(C), P), obs_point=np.tile(np.arange(P), C),
        obs_line=lines, obs_weight=np.ones(C * P), cam_dof_mask=mask,
        point_mask=np.ones(P))
    fields["qvecs"] /= np.linalg.norm(fields["qvecs"], axis=1, keepdims=True)
    return {k: (v.astype(dtype) if v.dtype == np.float64 else v)
            for k, v in fields.items()}


def main(mode: str, workdir: str, device: str = "cpu"):
    import torch
    import torch.distributed as dist

    from privacy_preserving_sfm_torch.parallel import multihost

    torch.set_num_threads(1)
    # gloo for several ranks, on the CPU or on one card; NCCL for one rank
    # on a card.
    if not multihost.initialize_from_env(backend="gloo", device=device):
        dist.init_process_group(  # a world of one rank
            "nccl" if device.startswith("cuda") else "gloo",
            init_method="tcp://" + os.environ["PPSFM_COORDINATOR"],
            world_size=1, rank=0, timeout=multihost.TIMEOUT)
    rank, world = dist.get_rank(), dist.get_world_size()
    group = multihost.global_mesh()
    try:
        if mode == "hang":
            if rank == 0:
                dist.all_reduce(torch.ones(1), group=group)
            else:
                time.sleep(3600)
            return
        inputs = np.load(os.path.join(workdir, "inputs.npz"))
        run = {"solve": solve, "multihost": multihost_check}[mode]
        out = run(inputs, rank, world, torch, group, torch.device(device))
        np.savez(os.path.join(workdir, f"{mode}_{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
