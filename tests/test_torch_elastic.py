"""Elastic re-mesh, restore onto a smaller mesh, and the compressed
all-reduce, on 8 gloo ranks (one process each, one intra-op thread).

* The reference's elastic scenario (``tests/test_elastic.py``): reduced
  qwen2.5-3b in float32 takes a step on a 4x2 ``(data, model)`` mesh;
  the two ranks of data row 1 fail; ``survivors_mesh`` keeps a 3x2
  mesh; the live ``remesh_state`` equals, bit for bit, the checkpoint
  restored onto the survivors (``restore(..., placements=)``), every
  leaf's shard on every survivor; one more step on the survivors with
  ``rules={"batch": None}`` gives a finite loss.
* ``compressed_psum`` over the ``pod`` (2) and ``data`` (4) dims of a
  2x4 mesh against the reference's under ``shard_map`` on 8 host
  devices (a subprocess: XLA's device count is fixed at start), on the
  same inputs: within two float32 ulps (the integer sums agree; XLA's
  CPU code rounds the last rescaling's last bit otherwise in a few
  percent of the entries).
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_ranks import ROOT, run_ranks  # noqa: E402

ELASTIC_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from torch.distributed.tensor import DTensor
    from repro_torch import configs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.convert import flat_train_state
    from repro_torch.sharding.plan import Plan, use_plan
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.data import DataConfig, make_batch
    from repro_torch.train.elastic import remesh_state, survivors_mesh
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.step import init_train_state, make_train_step

    d = sys.argv[1]
    dist.init_process_group("gloo")
    rank = dist.get_rank()
    cfg = configs.get_reduced("qwen2.5-3b").replace(dtype="float32")
    opt = adamw(lr=1e-3)
    mesh = make_mesh((4, 2), ("data", "model"), device_type="cpu")
    plan = Plan(mesh=mesh, fsdp=False)
    dc = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=8, seed=0)
    state = init_train_state(cfg, opt, device="cpu", plan=plan)
    with use_plan(plan):
        state, m0 = make_train_step(cfg, opt)(state, make_batch(dc, 0))
    ckpt.save(state, d, 1)
    dist.barrier()

    # the two ranks of data row 1 fail -> 3x2 survivors
    failed = mesh.mesh[1].tolist()
    new_mesh = survivors_mesh(mesh, failed)
    assert tuple(new_mesh.mesh.shape) == (3, 2), new_mesh.mesh.shape
    new_plan = Plan(mesh=new_mesh, fsdp=False)
    moved = remesh_state(state, plan, new_plan)       # every rank takes part
    if rank in failed:
        dist.destroy_process_group()
        sys.exit(0)

    target = init_train_state(cfg, opt, device="cpu")
    restored, _ = ckpt.restore(d, 1, target, placements=new_plan)
    n = 0
    for (na, a), (nb, b) in zip(flat_train_state(moved),
                                flat_train_state(restored)):
        assert na == nb
        la = a.to_local() if isinstance(a, DTensor) else a
        lb = b.to_local() if isinstance(b, DTensor) else b
        assert isinstance(a, DTensor) == (na not in ("opt.count", "step"))
        if isinstance(a, DTensor):
            assert a.device_mesh == new_mesh and b.device_mesh == new_mesh
            assert a.placements == b.placements, (na, a.placements)
        assert torch.equal(la, lb), na
        n += 1
    new_plan2 = Plan(mesh=new_mesh, fsdp=False, rules={"batch": None})
    with use_plan(new_plan2):
        restored, m2 = make_train_step(cfg, opt)(restored,
                                                 make_batch(dc, 1))
    assert np.isfinite(float(m2["loss"]))
    if rank == 0:
        with open(d + "/ok.txt", "w") as f:
            f.write(f"ELASTIC_OK {n} leaves, loss {float(m2['loss'])}")
    dist.destroy_process_group()
""")


def test_elastic_restart_after_node_failure(tmp_path):
    run_ranks(ELASTIC_WORKER, tmp_path)
    assert (tmp_path / "ok.txt").read_text().startswith("ELASTIC_OK")


PSUM_INPUTS = dict(shape=(3, 700), seed=7)

REF_PSUM = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    sys.path.insert(0, "src")
    from repro.launch.mesh import make_mesh
    from repro.train.compression import compressed_psum
    x = np.load(sys.argv[1])                       # [8, *shape]
    mesh = make_mesh((2, 4), ("pod", "data"))
    out = {}
    for axis in ("pod", "data"):
        f = jax.jit(jax.shard_map(
            lambda a: compressed_psum(a[0], axis)[None], mesh=mesh,
            in_specs=P(("pod", "data")), out_specs=P(("pod", "data"))))
        out[axis] = np.asarray(f(jnp.asarray(x)))
    np.savez(sys.argv[2], **out)
""")

PORT_PSUM = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.compression import compressed_psum
    d = sys.argv[1]
    dist.init_process_group("gloo")
    rank = dist.get_rank()
    x = torch.from_numpy(np.load(d + "/x.npy")[rank])
    mesh = make_mesh((2, 4), ("pod", "data"), device_type="cpu")
    out = {a: compressed_psum(x, mesh, a).numpy() for a in ("pod", "data")}
    np.savez(d + f"/port_{rank}.npz", **out)
    dist.destroy_process_group()
""")


def test_compressed_psum_matches_reference(tmp_path):
    rng = np.random.default_rng(PSUM_INPUTS["seed"])
    x = rng.standard_normal((8,) + PSUM_INPUTS["shape"]).astype(np.float32)
    x *= rng.uniform(0.5, 2.0, size=(8, 1, 1)).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    script = tmp_path / "ref_psum.py"
    script.write_text(REF_PSUM)
    r = subprocess.run([sys.executable, str(script), str(tmp_path / "x.npy"),
                        str(tmp_path / "ref.npz")], capture_output=True,
                       text=True, timeout=300, cwd=str(ROOT),
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    run_ranks(PORT_PSUM, tmp_path)
    ref = np.load(tmp_path / "ref.npz")
    for rank in range(8):
        got = np.load(tmp_path / f"port_{rank}.npz")
        for axis in ("pod", "data"):
            np.testing.assert_allclose(got[axis], ref[axis][rank],
                                       rtol=2.5e-7, atol=0,
                                       err_msg=f"{axis} rank {rank}")
