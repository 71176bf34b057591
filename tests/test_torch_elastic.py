"""Elastic checkpoints in the PyTorch port (``checkpoint/manager.py``
with ``ruleset=``) on gloo CPU ranks.

* Part 3 of the reference's ``MULTIDEV_SCRIPT``
  (``tests/test_sharding_dist.py``) ported: a tree saved unsharded is
  restored onto (2, 4) and (4, 2) FSDP meshes in one 8-rank group. Each
  rank's shard equals the slice its ``param_spec`` names (cut by hand
  from the saved array), and each leaf gathered back equals what was
  saved, bit for bit. Besides the script's ``w_gate`` (split over the
  model axis), a ``w_up`` of 131,072 elements is also split over "data"
  by FSDP.
* A checkpoint that a (2, 1) FSDP run of the trainer writes at step 2
  holds every leaf whole (the keys, shapes and dtypes of a one-rank
  run's), and restores on one rank and on (1, 2): the next step's loss
  equals the uninterrupted (2, 1) run's within 1e-5 relative (the ranks
  reorder fp32 sums).

Rank functions in ``tests/_torch_train_workers.py``.
"""

import os

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager, load_checkpoint
from repro_torch.launch import mesh as mesh_lib
from repro_torch.train import steps
from repro_torch.tree import tree_items

import _torch_train_workers as workers

MESHES = [(2, 4), (4, 2)]
ARCH = "qwen3-4b"
LOSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def restored(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("elastic"))
    rng = np.random.RandomState(0)
    tree = {"mlp": {"w_gate": rng.randn(32, 64).astype(np.float32),
                    "w_up": rng.randn(256, 512).astype(np.float32)}}
    mgr = CheckpointManager(d)
    mgr.save(3, {k: {n: torch.from_numpy(a) for n, a in v.items()}
                 for k, v in tree.items()})
    mgr.wait()
    ranks = mesh_lib.run_ranks(workers.elastic_restore, 8,
                               args=(d, tree, MESHES), deadline_s=90.0)
    return tree, ranks


def test_restore_cuts_each_rank_its_param_spec_slice(restored):
    tree, ranks = restored
    for r in ranks:
        for got, shape in zip(r, MESHES):
            assert got["shape"] == list(shape) and got["step"] == 3
            for leaf in got["leaves"].values():
                assert leaf["shard_equal"]
    specs = {tuple(got["shape"]): {k: v["spec"] for k, v in
                                   got["leaves"].items()}
             for got in ranks[0]}
    # w_gate (32, 64): mlp over the model axis (too small for FSDP);
    # w_up (256, 512): mlp over "model" and FSDP over "data".
    for shape in MESHES:
        assert specs[shape]["mlp/w_gate"] == [None, "model"]
        assert specs[shape]["mlp/w_up"] == ["data", "model"]


def test_restored_leaves_gather_back_to_what_was_saved(restored):
    tree, ranks = restored
    for r in ranks:
        for got in r:
            for key, leaf in got["leaves"].items():
                k, n = key.split("/")
                np.testing.assert_array_equal(leaf["gathered"], tree[k][n])


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("resume"))
    ranks = mesh_lib.run_ranks(workers.elastic_resume, 2,
                               args=(root, ARCH), deadline_s=120.0)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = workers.run_trainer(ARCH, 3, os.path.join(root, "one_rank"))
    finally:
        torch.set_num_threads(n)
    return root, ranks, one


def test_a_sharded_checkpoint_holds_every_leaf_whole(resumed):
    root = resumed[0]
    cfg = configs.get_smoke(ARCH)
    like = steps.init_state(cfg, 0, "cpu").tree()
    got, manifest = load_checkpoint(os.path.join(root, "one_rank"), like,
                                    step=2)
    assert manifest["step"] == 2 and int(got["step"]) == 2
    for (k, a), (_, b) in zip(tree_items(got), tree_items(like)):
        assert a.shape == b.shape and a.dtype == b.dtype, k


def test_resumed_steps_equal_the_uninterrupted_run(resumed):
    """Step 3's loss resumed on (1, 2) and on one rank equals the
    uninterrupted (2, 1) FSDP run's; steps 1-2 of the two (2, 1) runs
    agree; the resumed runs took exactly step 3."""
    _, ranks, one = resumed
    for r in ranks:
        fresh = {m["step"]: m["loss"] for m in r["fresh"]}
        assert [m["step"] for m in r["first"]] == [1, 2]
        for m in r["first"]:
            assert m["loss"] == pytest.approx(fresh[m["step"]],
                                              rel=LOSS_RTOL)
        for run in (r["resumed"], one):
            assert [m["step"] for m in run] == [3]
            assert run[0]["loss"] == pytest.approx(fresh[3], rel=LOSS_RTOL)
