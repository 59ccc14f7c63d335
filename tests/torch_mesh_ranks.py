"""Rank bodies of ``tests/test_torch_mesh.py``'s gloo meshes.

``launch.mesh.spawn_local`` loads this file in each spawned rank process
(it imports neither jax nor the reference, so a rank starts fast) and calls
``run(rank, world, init_method, inputs)``: the rank joins its (2, world / 2)
gloo mesh (``mpc_serving_mesh`` over ``WORLD_SIZE`` ranks), loads the
inputs the test process saved, and returns its mesh's shape and its
coordinates, its censuses, output blocks and (rank 0) the gathered outputs.
"""
import os

import torch


def run(rank, world, init_method, inputs):
    torch.set_num_threads(1)
    from repro_torch import api
    from repro_torch.configs import RESNET_SMOKE
    from repro_torch.core import beaver, comm as comm_lib, gmw
    from repro_torch.launch.mesh import mpc_serving_mesh
    from repro_torch.models import resnet

    os.environ["WORLD_SIZE"] = str(world)
    mesh = mpc_serving_mesh(backend="gloo", device="cpu", init_method=init_method,
                            rank=rank)
    job = torch.load(inputs, weights_only=False)
    party = mesh.coords["party"]
    got = {"shape": mesh.shape, "coords": mesh.coords}
    if "relu" in job:
        keys, xs, trs = job["relu"]
        for cone in (False, True):
            cc = comm_lib.CoalescingComm(comm_lib.MeshComm("party", 2, mesh=mesh))
            outs = gmw.relu_many(keys, [x[party:party + 1] for x in xs],
                                 [beaver.slice_party_bundle(t, party) for t in trs[cone]],
                                 cc, [(k, m) for _, k, m in job["relu_specs"]], cone=cone)
            got[("relu", cone)] = ([(c.count, c.bytes) for c in cc.base.census],
                                   [mesh.gather(o, ("party",)) for o in outs])
    plan, params, x, pool, key = job["model"]
    model = api.compile(
        lambda p, v, relu_fn=None: resnet.apply(p, v, RESNET_SMOKE, relu_fn=relu_fn),
        params, RESNET_SMOKE, plan, api.Session(key=0, device="cpu"))
    step = model.jit_step(mesh, data_axis=job["data_axis"])
    assert step is model.jit_step(mesh, data_axis=job["data_axis"])
    if job["data_axis"]:
        pool = beaver.shard_pool(pool, mesh.shape["data"])
    block = step(model.params, x, pool, key)
    got["step"] = ([(c.count, c.bytes) for c in step.census], block,
                   mesh.gather(block, step.spec))
    return got
