"""Port's streaming feature feed (``murcl_tpu_torch.data.streaming``) against
the JAX package's and against the port's resident bank, on the CPU.

- A staged mini-bank holds what JAX's ``StreamingBank.stage`` holds once
  JAX's 8-row slide alignment, its row bucket and its 128-patch table width
  are stripped: per slide the feature rows, ``num_patches``,
  ``cluster_sizes``, ``patch_cluster``, ``patch_pos`` and the label; the
  port stages each distinct slide once and maps repeats onto it.
- ``select_feats`` on the port's mini-bank equals JAX's ``select_feats`` on
  JAX's, bitwise (as ``tests/test_streaming.py`` holds JAX's to its resident
  bank).
- The contrastive and the supervised ``train_step`` on a mini-bank equal the
  same steps on the resident bank, bitwise in f32, with repeated ids.
- ``iter_epoch`` yields every batch in order, and an error of its producer
  thread reaches the caller.
- ``train_MuRCL --streaming`` (stage 1) and ``train_RLMIL --streaming``
  (stages 1 -> 2 -> 3) write the same ``losses.csv``, ``final_res.csv`` and
  ``pred.csv`` as without ``--streaming``.
"""

import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from murcl_tpu.data.streaming import StreamingBank as JaxStreamingBank
from murcl_tpu.ops.select import select_feats as jax_select_feats
from murcl_tpu_torch import train_MuRCL, train_RLMIL
from murcl_tpu_torch.data import contract
from murcl_tpu_torch.data.bank import build_bank
from murcl_tpu_torch.data.sources import ResidentSource, StreamingSource, build_sources
from murcl_tpu_torch.data.streaming import StreamingBank, npy_member_span
from murcl_tpu_torch.drivers import murcl, rlmil
from murcl_tpu_torch.ops.select import select_feats

IDS = np.array([5, 1, 3, 1, 0, 5, 7], dtype=np.int32)  # repeats, out of order


def test_stage_holds_jax_stage(synthetic_dataset):
    ds = synthetic_dataset
    jstream = JaxStreamingBank(ds["data_csv"], row_bucket=128)
    stream = StreamingBank(ds["data_csv"])
    assert stream.case_ids == jstream.case_ids and stream.patch_dim == jstream.patch_dim
    jbank, jslide_ids, jlabels = jstream.stage(IDS)
    bank, slide_ids = stream.stage(IDS)
    assert bank.feats.shape[0] == sum(stream.num_patches[np.unique(IDS)])  # distinct, packed
    assert bank.num_slides == len(np.unique(IDS))
    np.testing.assert_array_equal(np.asarray(jslide_ids), np.arange(IDS.size))
    jfeats, joffs = np.asarray(jbank.feats), np.asarray(jbank.offsets)
    assert (joffs % 8 == 0).all() and jfeats.shape[0] % 128 == 0  # JAX's layout, stripped here
    width = stream.max_patches
    for j, slide in enumerate(IDS):
        i = int(slide_ids[j])
        n = int(bank.num_patches[i])
        assert n == int(jbank.num_patches[j]) == stream.num_patches[slide]
        off = int(bank.offsets[i])
        np.testing.assert_array_equal(bank.feats[off:off + n].numpy(),
                                      jfeats[joffs[j]:joffs[j] + n])
        np.testing.assert_array_equal(bank.cluster_sizes[i].numpy(), jbank.cluster_sizes[j])
        jpc, jpp = np.asarray(jbank.patch_cluster[j]), np.asarray(jbank.patch_pos[j])
        np.testing.assert_array_equal(bank.patch_cluster[i].numpy(), jpc[:width])
        np.testing.assert_array_equal(bank.patch_pos[i].numpy(), jpp[:width])
        assert (jpp[width:] == -1).all()  # JAX's wider table holds only padding
        assert int(bank.labels[i]) == int(jlabels[j]) == stream.labels[slide]


def test_select_feats_matches_jax_bitwise(synthetic_dataset):
    import jax.numpy as jnp

    ds = synthetic_dataset
    jstream = JaxStreamingBank(ds["data_csv"], row_bucket=128)
    jbank, jslide_ids, _ = jstream.stage(IDS)
    bank, slide_ids = StreamingBank(ds["data_csv"]).stage(IDS)
    actions = np.random.default_rng(0).random((IDS.size, jstream.num_clusters)).astype(
        np.float32)
    want = jax_select_feats(jbank.feats, jslide_ids, jbank.offsets, jbank.num_patches,
                            jbank.cluster_tables, jbank.cluster_sizes, jnp.asarray(actions),
                            feat_size=32, max_patches=jstream.max_patches)
    got = select_feats(bank, slide_ids, torch.tensor(actions), 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # and the port's resident bank agrees
    resident = build_bank(ds["data_csv"])
    np.testing.assert_array_equal(
        select_feats(resident, torch.tensor(IDS, dtype=torch.int64), torch.tensor(actions),
                     32).numpy(), got.numpy())


def test_stage_dtypes_and_a_compressed_member(synthetic_dataset, tmp_path):
    """A mini-bank staged in f32 or bf16 equals the resident bank cast to
    that dtype; a compressed npz member (no byte offset) is read through
    ``np.load``."""
    ds = synthetic_dataset
    actions = torch.rand(IDS.size, 5, generator=torch.Generator().manual_seed(1))
    for dtype, view in ((torch.float32, torch.int32), (torch.bfloat16, torch.int16)):
        resident = build_bank(ds["data_csv"]).to("cpu", dtype=dtype)
        want = select_feats(resident, torch.tensor(IDS, dtype=torch.int64), actions, 48)
        bank, sid = StreamingBank(ds["data_csv"], dtype=dtype).stage(IDS)
        assert bank.feats.dtype == dtype
        assert torch.equal(select_feats(bank, sid, actions, 48).view(view), want.view(view)), dtype

    rows = contract.load_manifest(ds["data_csv"])
    assert npy_member_span(rows[0]["features_filepath"])[0] is not None
    with np.load(rows[0]["features_filepath"]) as z:
        members = {k: z[k] for k in z.files}
    packed = tmp_path / "packed.npz"
    np.savez_compressed(packed, **members)
    offset, shape, dtype = npy_member_span(packed)
    assert offset is None and shape == members["img_features"].shape and dtype == np.float32
    rows[0]["features_filepath"] = str(packed)
    csv_path = tmp_path / Path(ds["data_csv"]).name
    contract.save_manifest(csv_path, rows)
    bank, sid = StreamingBank(csv_path).stage([0, 1])
    n = int(bank.num_patches[0])
    np.testing.assert_array_equal(bank.feats[:n].numpy(), members["img_features"])


def test_sources_share_max_patches(synthetic_dataset):
    ds = synthetic_dataset
    split = contract.load_split(ds["data_split_json"])
    sources = build_sources(ds["data_csv"], split, streaming=True)
    widths = {s.max_patches for s in sources.values()}
    assert len(widths) == 1 and all(isinstance(s, StreamingSource) for s in sources.values())
    largest = max(StreamingBank(ds["data_csv"], idx).max_patches for idx in split.values())
    assert widths == {largest}
    bank, _ = sources["test"].batch([0])
    assert bank.patch_cluster.shape[1] == largest
    resident = build_sources(ds["data_csv"], split)
    assert all(isinstance(s, ResidentSource) for s in resident.values())
    with pytest.raises(ValueError, match="max_patches"):
        stream = StreamingBank(ds["data_csv"])
        stream.max_patches -= 1
        stream.stage([0])


def _step_pair(module, args):
    """The same driver setup over the resident bank and over the stream."""
    return (module.setup(module.default_args(**args, streaming=False, save_dir="resident")),
            module.setup(module.default_args(**args, streaming=True, save_dir="stream")))


def _assert_same_weights(a, b):
    for x, y in ((a.model, b.model), (a.fc, b.fc)):
        for (k, v), w in zip(x.state_dict().items(), y.state_dict().values()):
            assert torch.equal(v, w), k


@pytest.mark.parametrize("arch", ["CLAM_SB", "ABMIL"])
def test_contrastive_step_on_a_mini_bank_is_bitwise(synthetic_dataset, tmp_path, arch):
    ds = synthetic_dataset
    res, stm = _step_pair(murcl, dict(
        data_csv=ds["data_csv"], data_split_json=ds["data_split_json"], device="cpu",
        arch=arch, batch_size=IDS.size, feat_size=24, T=3, base_save_dir=str(tmp_path)))
    _assert_same_weights(res, stm)
    split_ids = np.array([0, 2, 1, 0, 3, 2, 3])  # into the train split, repeats
    for _ in range(2):
        a = res.engine.train_step(res.source.bank, torch.tensor(split_ids),
                                  torch.Generator().manual_seed(3))
        bank, sid = stm.source.batch(split_ids)
        b = stm.engine.train_step(bank, sid, torch.Generator().manual_seed(3))
        assert torch.equal(a.step_losses, b.step_losses) and torch.equal(a.rewards, b.rewards)
        _assert_same_weights(res, stm)


def test_supervised_step_on_a_mini_bank_is_bitwise(synthetic_dataset, tmp_path):
    ds = synthetic_dataset
    res, stm = _step_pair(rlmil, dict(
        data_csv=ds["data_csv"], data_split_json=ds["data_split_json"], device="cpu",
        batch_size=IDS.size, feat_size=24, T=3, base_save_dir=str(tmp_path)))
    split_ids = np.array([3, 0, 0, 1, 2, 3, 1])
    valid = torch.tensor([True] * 6 + [False])
    for _ in range(2):
        a = res.engine.train_step(res.sources["train"].bank, torch.tensor(split_ids),
                                  torch.Generator().manual_seed(4), valid=valid)
        bank, sid = stm.sources["train"].batch(split_ids)
        b = stm.engine.train_step(bank, sid, torch.Generator().manual_seed(4), valid=valid)
        assert torch.equal(a.step_losses, b.step_losses) and torch.equal(a.logits, b.logits)
        _assert_same_weights(res, stm)


def test_iter_epoch_in_order_and_producer_errors_reach_the_caller(synthetic_dataset):
    stream = StreamingBank(synthetic_dataset["data_csv"])
    batches = [np.array([0, 1, 1]), np.array([2, 3]), np.array([7, 4, 4, 7]), np.array([5])]
    seen = 0
    for (bank, sid), ids in zip(stream.iter_epoch(batches), batches):
        np.testing.assert_array_equal(bank.labels[sid].numpy(), stream.labels[ids])
        np.testing.assert_array_equal(bank.num_patches[sid].numpy(), stream.num_patches[ids])
        seen += 1
    assert seen == len(batches)

    real_stage, calls = stream._stage, []

    def failing(ids, k):
        calls.append(threading.current_thread().name)
        if len(calls) == 2:
            raise OSError("feature file vanished")
        return real_stage(ids, k)

    stream._stage = failing
    got = []
    with pytest.raises(OSError, match="vanished"):
        for bank, sid in stream.iter_epoch(batches):
            got.append(bank)
    assert len(got) == 1 and calls == ["stream-prefetch"] * 2
    # a consumer that stops early stops the producer
    stream._stage = real_stage
    it = stream.iter_epoch(batches)
    next(it)
    it.close()
    assert not any(t.name == "stream-prefetch" for t in threading.enumerate())


def _csv(run, name):
    return (Path(run) / name).read_text()


def test_murcl_cli_streaming_writes_the_same_losses(synthetic_dataset, tmp_path):
    ds = synthetic_dataset
    argv = ["--data_csv", ds["data_csv"], "--data_split_json", ds["data_split_json"],
            "--device", "cpu", "--epochs", "2", "--batch_size", "3", "--data_repeat", "3",
            "--feat_size", "24", "--T", "3", "--base_save_dir", str(tmp_path)]
    runs = [train_MuRCL.main(argv + ["--save_dir", name] + extra)["save_dir"]
            for name, extra in (("resident", []), ("stream", ["--streaming"]))]
    assert _csv(runs[0], "losses.csv") == _csv(runs[1], "losses.csv")
    assert len(_csv(runs[0], "losses.csv").splitlines()) == 3


def test_rlmil_cli_streaming_writes_the_same_results(synthetic_dataset, tmp_path):
    ds = synthetic_dataset
    runs = {}
    for mode, extra in (("resident", []), ("stream", ["--streaming"])):
        for stage in (1, 2, 3):
            out = train_RLMIL.main(
                ["--data_csv", ds["data_csv"], "--data_split_json", ds["data_split_json"],
                 "--device", "cpu", "--feat_size", "16", "--T", "2", "--batch_size", "3",
                 "--epochs", "2", "--ppo_epochs", "1", "--train_stage", str(stage), "--save_model",
                 "--base_save_dir", str(tmp_path / mode), *extra])
            runs[mode, stage] = out["save_dir"]
    for stage in (1, 2, 3):
        for name in ("losses.csv", "final_res.csv", "pred.csv"):
            assert _csv(runs["resident", stage], name) == _csv(runs["stream", stage], name), (
                stage, name)
