"""Multi-host scale-out over torch.distributed.

Counterpart of cama_tpu/parallel/multihost.py.  Within a host the
('frames', 'points') mesh of parallel/sharding.py shards one scene; across
hosts, sharding happens at the scene granularity: each host processes
whole clips, and only scene-level metric partials (plain sums, see
eval.map_metrics) cross hosts.  Nothing per-frame ever crosses hosts.

JAX runs one process per host over all of its devices; PyTorch runs one
process per rank.  So a JAX process maps to a node here and a JAX device
to a rank: a node holds LOCAL_WORLD_SIZE ranks (1 when the launcher set
none), numbered contiguously, and its index is rank // LOCAL_WORLD_SIZE.

Pieces:
  * initialize()             - torch.distributed bootstrap over a TCP
                               store (no-op for a single process)
  * global_mesh()            - ('hosts', 'local') mesh over every rank
  * virtual_hosts_mesh()     - the same topology at sizes the caller picks
  * assign_scenes()          - host-level scene round-robin
  * run_local_scenes()       - per-scene runner with failure isolation
  * reduce_metric_partials() - every host's metric partials, summed, on
                               every rank
  * cross_host_metric_sum()  - the sum of metric partials over a mesh's
                               'hosts' axis
  * allgather_host_results() - every host's payload array on every rank
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from cama_tpu_torch.parallel.sharding import Mesh, _world


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               backend=None):
    """Join this process to a torch.distributed world of num_processes
    ranks as rank process_id, through the TCP store at coordinator_address
    ('host:port', served by rank 0).  A safe no-op for a single process
    (returns False).

    backend: as asked ('nccl' or 'gloo'); None is NCCL where PyTorch sees
    a card and gloo where it does not.  Several ranks that share one card
    need 'gloo' (NCCL refuses two ranks on one device); gloo runs its
    collectives on CUDA tensors through host memory."""
    if num_processes is None or num_processes <= 1:
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id))
    return True


def _ranks_per_host():
    return max(1, int(os.environ.get("LOCAL_WORLD_SIZE", 1)))


def _host_count():
    """The number of hosts (nodes) in the world."""
    return max(1, _world() // _ranks_per_host())


def _host_index():
    """This rank's host (node) index."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    return rank // _ranks_per_host()


def global_mesh(device="cuda"):
    """The 2-D global mesh [hosts, ranks per host] with axes ('hosts',
    'local'): collectives over 'hosts' cross hosts, over 'local' stay
    within one.  Within a host, its ranks can be laid out as the
    ('frames', 'points') mesh of parallel.sharding.make_mesh."""
    local = _ranks_per_host()
    if _world() % local:
        raise ValueError(f"a world of {_world()} ranks does not divide into "
                         f"hosts of LOCAL_WORLD_SIZE={local}")
    return Mesh(("hosts", "local"), (_world() // local, local), device)


def virtual_hosts_mesh(n_hosts, per_host=1, device="cuda"):
    """The ('hosts', 'local') topology at the sizes given, over the
    world's ranks, so the cross-host programs run with the same sharding
    on one machine (tests) as across hosts."""
    need = n_hosts * per_host
    if _world() < need:
        raise ValueError(f"need {need} ranks, have {_world()}")
    return Mesh(("hosts", "local"), (n_hosts, per_host), device)


def global_scene_mesh(device="cuda"):
    """Deprecated round-1 name for global_mesh()."""
    return global_mesh(device)


def assign_scenes(scene_names, process_index=None, process_count=None):
    """Round-robin scene list over hosts (host-level data parallelism, the
    analogue of the reference's outer scene loop)."""
    n = process_count if process_count is not None else _host_count()
    i = process_index if process_index is not None else _host_index()
    return [s for k, s in enumerate(scene_names) if k % n == i]


def run_local_scenes(scene_names, process_fn, **assign_kw):
    """Process this host's scene shard with per-scene failure isolation
    (one bad scene must not kill the batch).  Returns ({scene: result},
    [(scene, error_repr)])."""
    results, failures = {}, []
    for scene in assign_scenes(scene_names, **assign_kw):
        try:
            results[scene] = process_fn(scene)
        except Exception as e:  # noqa: BLE001 - isolation is the contract
            failures.append((scene, repr(e)))
    return results, failures


def reduce_metric_partials(local_partial, metric_keys):
    """The multi-process reduction: each host contributes its own
    scene-metric partial dict; every rank receives the global sums, as
    float32 like the JAX package's.  O(#metrics) floats cross hosts
    (allgather_host_results; identity in a single process)."""
    keys = tuple(sorted(metric_keys))
    vec = np.asarray([float(local_partial.get(k, 0.0)) for k in keys],
                     np.float32)
    totals = allgather_host_results(vec).sum(axis=0)  # [n_hosts, n_keys]
    return {k: float(v) for k, v in zip(keys, totals)}


def cross_host_metric_sum(mesh, metric_keys):
    """The sum of metric partials over a mesh's 'hosts' axis.

    Returns run(per_host_partials), where per_host_partials is the list
    (one {key: float} per host) that every rank holds: each rank
    contributes its own host's row, and an all_reduce(SUM) over the hosts
    group gives every rank the sums (float32), as the JAX package's
    single-controller psum over the same list does."""
    keys = tuple(sorted(metric_keys))

    def run(per_host_partials):
        n = mesh.shape["hosts"]
        if len(per_host_partials) != n:
            raise ValueError(f"{len(per_host_partials)} partials for {n} "
                             "hosts")
        row = per_host_partials[mesh.coord("hosts")]
        t = torch.tensor([float(row.get(k, 0.0)) for k in keys],
                         dtype=torch.float32, device=mesh.device)
        mesh.all_reduce(t, dist.ReduceOp.SUM, ("hosts",))
        return {k: float(v) for k, v in zip(keys, t.tolist())}

    return run


def allgather_host_results(payload):
    """Every host's payload array on every rank: [n_hosts, ...] in host
    order (the first rank of each host speaks for it).  Identity, with a
    leading axis of 1, in a single process."""
    a = np.asarray(payload)
    if _world() == 1:
        return a[None]
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.as_tensor(a).to(dev).contiguous()
    parts = [torch.empty_like(t) for _ in range(_world())]
    dist.all_gather(parts, t)
    return torch.stack(parts)[::_ranks_per_host()].cpu().numpy()
