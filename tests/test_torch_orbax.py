"""The JAX package's Orbax checkpoints read and written by the port (``ckpt_format``, ``checkpoint``).

Held against the JAX package and against the libraries installed here (only
this file imports ``zstandard`` and ``tensorstore``):

* zstd: the C++ decoder against ``zstandard`` over seeded payloads at levels
  1, 3 and 19, with and without a checksum or a content size; concatenated
  frames; the raw-block writer's frames read by ``zstandard``; malformed
  frames raise ``ValueError``.
* OCDBT: tensorstore's stores (inline and indirect values, several leaves)
  read byte for byte, and the port's stores read by tensorstore.
* zarr: chunk grids with a missing chunk, fill values and every dtype, as
  tensorstore writes them.
* JAX -> port: a ``TRAIN_TINY`` TrainState with Adam moments, counts and a
  scheduled chain, saved by the JAX ``save_state``, restores bit for bit,
  and one Adam update from it agrees with optax's in float64.
* port -> JAX: ``save_jax_state`` is read back by the JAX ``restore_state``
  leaf for leaf; the JAX and port ``best_step`` agree; the port's Trainer
  resumes a JAX-written ``ckpt_dir``; a step with both kinds and a missing
  or extra leaf raise.

The JAX checkpoint (and the optax update) is made once per run through
``run_once``; the tests copy it before they change anything.
"""

import json
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

from skillful_nowcasting_tpu_torch import DGMR, checkpoint, training
from skillful_nowcasting_tpu_torch.ckpt_format import ocdbt, tree as orbax_tree, zarr, zstd
from skillful_nowcasting_tpu_torch.data import synthetic_radar_batches
from skillful_nowcasting_tpu_torch.hub.convert import param_paths
from skillful_nowcasting_tpu_torch.trainer import Trainer
from torch_port_helpers import TRAIN_TINY, _shared_dir, run_once

torch.set_num_threads(1)

zstandard = pytest.importorskip("zstandard")
ts = pytest.importorskip("tensorstore")

G_SCHEDULE = "cosine:100"  # G: a scheduled chain; D: a fixed lr (EmptyState)
STEP, BEST_STEP = 3, 5


# ---------------------------------------------------------------- zstd

def _payloads():
    rng = np.random.default_rng(0)
    text = b"".join(b"grid cell %d rain rate %d mm/h; " % (i % 97, i % 13) for i in range(9000))
    return {
        "f32_noise": rng.standard_normal(1 << 18).astype(np.float32).tobytes(),  # 1 MiB
        "zeros": bytes(200_000),
        "text": text,
        "several_blocks": rng.integers(0, 16, 400_000, dtype=np.uint8).tobytes(),
        "empty": b"",
    }


PAYLOADS = _payloads()


@pytest.mark.parametrize("level", [1, 3, 19])
@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_zstd_decoder_matches_zstandard(level, name):
    data = PAYLOADS[name]
    for checksum in (False, True):
        for content_size in (False, True):
            frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                             write_content_size=content_size).compress(data)
            assert zstd.decompress(frame) == data, (checksum, content_size)
            out = bytearray(len(data))
            assert zstd.decompress_into(frame, out) == len(data) and out == data


def test_zstd_concatenated_frames_and_raw_writer():
    a, b = PAYLOADS["text"], PAYLOADS["f32_noise"]
    frames = (zstandard.ZstdCompressor(level=3).compress(a)
              + zstandard.ZstdCompressor(level=1, write_checksum=True).compress(b))
    assert zstd.decompress(frames) == a + b
    for name, data in PAYLOADS.items():
        raw = zstd.compress_raw(data)
        assert zstandard.ZstdDecompressor().decompress(raw) == data, name
        assert zstd.content_size(raw) == len(data) and zstd.decompress(raw) == data, name


def _truncated():
    return zstandard.ZstdCompressor(level=3).compress(PAYLOADS["text"])[:-20]


def _bad_magic():
    return b"\x00" + zstandard.ZstdCompressor(level=3).compress(PAYLOADS["text"])[1:]


def _bad_checksum():
    frame = bytearray(zstandard.ZstdCompressor(level=3, write_checksum=True)
                      .compress(PAYLOADS["text"]))
    frame[-1] ^= 0xFF
    return bytes(frame)


@pytest.mark.parametrize("make, match", [(_truncated, "truncated"), (_bad_magic, "magic"),
                                         (_bad_checksum, "checksum")],
                         ids=["truncated", "bad_magic", "bad_checksum"])
def test_zstd_malformed_frames_raise(make, match):
    with pytest.raises(ValueError, match=match):
        zstd.decompress(make())


# ---------------------------------------------------------------- OCDBT and zarr

def _ts_read(directory):
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{directory}/"}).result()
    return {k.decode(): kv.read(k).result().value for k in kv.list().result()}


def _random_kv(seed, n=60):
    rng = np.random.default_rng(seed)
    return {f"key/{i:03d}/{'v' * (i % 5)}": rng.bytes(int(rng.integers(0, 400))) for i in range(n)}


def test_ocdbt_reads_tensorstore_stores(tmp_path):
    """Inline and indirect values, more than one leaf (and a level of interior nodes)."""
    kv = _random_kv(1)
    store = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/",
                             "config": {"max_decoded_node_bytes": 600,
                                        "max_inline_value_bytes": 100}}).result()
    with ts.Transaction() as txn:
        for k, v in kv.items():
            store.with_transaction(txn)[k] = v
    assert ocdbt.read_kv(str(tmp_path)) == kv == _ts_read(tmp_path)


@pytest.mark.parametrize("node_bytes", [ocdbt.MAX_DECODED_NODE_BYTES, 600, 250])
def test_ocdbt_writer_is_read_by_tensorstore(tmp_path, node_bytes):
    kv = _random_kv(2)
    kv["big"] = np.random.default_rng(3).bytes(5000)  # indirect under the default limit too
    ocdbt.write_kv(str(tmp_path), kv, max_decoded_node_bytes=node_bytes)
    assert _ts_read(tmp_path) == kv
    assert ocdbt.read_kv(str(tmp_path)) == kv


@pytest.mark.parametrize("dtype, compressor", [
    ("<f4", "zstd"), ("<f8", None), ("<i4", "zstd"), ("<i8", "zstd"), ("<u4", None),
    ("|b1", "zstd"), ("bfloat16", "zstd")])
def test_zarr_chunk_grid_matches_tensorstore(tmp_path, dtype, compressor):
    """A 7x9 array in 3x4 chunks with two chunks never written (the fill value), C order."""
    rng = np.random.default_rng(4)
    fill = {"|b1": True, "bfloat16": 1.5}.get(dtype, 3)
    spec = {"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{tmp_path}/"},
            "path": "arr", "metadata": {
                "shape": [7, 9], "chunks": [3, 4], "dtype": dtype, "fill_value": fill,
                "compressor": None if compressor is None else {"id": "zstd", "level": 3}},
            "create": True}
    store = ts.open(spec).result()
    values = rng.standard_normal((7, 9)) * 100
    if dtype == "bfloat16":
        values = values.astype(store.dtype.numpy_dtype)
    else:
        values = values.astype(np.dtype(dtype))
    store[:3, :].write(values[:3, :]).result()
    store[3:, 4:].write(values[3:, 4:]).result()  # chunks (1, 0) and (2, 0) stay missing
    want = store.read().result()
    kv = ocdbt.read_kv(str(tmp_path))
    assert "arr/1.0" not in kv and "arr/2.0" not in kv
    got = zarr.decode("arr", kv)
    if dtype == "bfloat16":
        assert got.dtype == torch.bfloat16
        assert np.array_equal(got.view(torch.int16).numpy(), np.asarray(want).view(np.int16))
    else:
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_zarr_refuses_what_it_cannot_read():
    meta = json.loads(zarr.encode("a", np.zeros(3, np.float32))["a/.zarray"])
    for key, value in (("order", "F"), ("dtype", "<f2"), ("compressor", {"id": "blosc"})):
        with pytest.raises(ValueError, match="'a'"):
            zarr.parse_zarray("a", json.dumps({**meta, key: value}).encode())


# ---------------------------------------------------------------- the JAX TrainState

def _link_tree(src, dst):
    """A copy of a step directory whose files are hard links (a TRAIN_TINY step is 136 MB)."""
    shutil.copytree(src, dst, copy_function=os.link)


def _jax_checkpoint(directory):
    """``start()`` of run_once: the JAX package writes a TRAIN_TINY state; returns the references.

    The optax states are built from numpy (``tx.init`` would compile an op
    per leaf shape); one jitted update of each chain is the float64 reference.
    """
    import optax

    from skillful_nowcasting_tpu import DGMR as JaxDGMR
    from skillful_nowcasting_tpu import checkpoint as jckpt
    from skillful_nowcasting_tpu import training as jtraining
    from skillful_nowcasting_tpu.hub.pretrained import abstract_variables

    jmodel = JaxDGMR(**TRAIN_TINY)
    rng = np.random.default_rng(6)

    def fill(path, a):  # numpy draws: no JAX op, so nothing compiles
        name = jax.tree_util.keystr(path)
        if "'var'" in name:
            return (rng.random(a.shape) + 0.5).astype(a.dtype)
        if "'uv'" in name:
            x = rng.standard_normal(a.shape)
            return (x / np.linalg.norm(x)).astype(a.dtype)
        return (rng.standard_normal(a.shape) * 0.05).astype(a.dtype)

    variables = jax.tree_util.tree_map_with_path(fill, dict(abstract_variables(jmodel)))
    g_tx, d_tx = jtraining.make_optimizers(jmodel, g_lr_schedule=G_SCHEDULE)
    g, d = jtraining.split_params(variables["params"])
    count = np.int32(STEP)

    def adam(params):
        mu = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32) * 1e-3, params)
        nu = jax.tree.map(lambda a: (rng.random(a.shape).astype(np.float32) + 0.1) * 1e-6, params)
        return optax.ScaleByAdamState(count=count, mu=mu, nu=nu)

    state = jtraining.TrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        spectral=variables["spectral"],
        g_opt_state=(adam(g), optax.ScaleByScheduleState(count=count)),
        d_opt_state=(adam(d), optax.EmptyState()), step=count)
    host = state
    state = jax.tree.map(jax.device_put, state)
    key = jax.random.key(11)
    best = jckpt.make_manager(os.path.join(directory, "best"), max_to_keep=3,
                              monitor="train/g_loss", keep_best=True)
    for step, loss in ((STEP, 0.5), (BEST_STEP, 0.25)):
        jckpt.save_state(best, step, state, key, {"train/g_loss": loss})
    best.wait_until_finished()
    # latest/: the same step as a manager without best tracking keeps it (no metrics).
    _link_tree(os.path.join(directory, "best", str(STEP)),
               os.path.join(directory, "latest", str(STEP)))
    shutil.rmtree(os.path.join(directory, "latest", str(STEP), "metrics"))

    # One Adam update of each chain in float64 from the saved state, in one program.
    f64 = lambda t: jax.tree.map(  # noqa: E731
        lambda a: a.astype(np.float64) if np.issubdtype(np.asarray(a).dtype, np.floating) else a, t)
    grads = jax.tree.map(lambda a: rng.standard_normal(a.shape) * 1e-2, variables["params"])
    gg, gd = jtraining.split_params(grads)

    def update(grads, states, params):
        return [optax.apply_updates(p, tx.update(gr, s, p)[0])
                for tx, gr, s, p in zip((g_tx, d_tx), grads, states, params)]

    with jax.enable_x64(True):
        out = jax.tree.map(np.array, jax.jit(update)(
            [gg, gd], f64([host.g_opt_state, host.d_opt_state]), f64([g, d])))
    return lambda: {"state": host, "key": np.array(jax.random.key_data(key)),
                    "grads": grads, "updated": jtraining.merge_params(*out)}


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    directory = str(_shared_dir(tmp_path_factory) / "orbax_jax_train_tiny")
    ref, _ = run_once(tmp_path_factory, "test_torch_orbax_jax_checkpoint",
                      lambda: _jax_checkpoint(directory))
    return directory, ref


def _torch_sd(variables):
    """The JAX package's own conversion to the torch layout (the expected values)."""
    from skillful_nowcasting_tpu.hub.export import export_torch_state_dict

    return {k: torch.from_numpy(np.array(v)) for k, v in export_torch_state_dict(variables).items()}


def _port_state():
    model = DGMR(**TRAIN_TINY, device="cpu")
    return training.init_train_state(model, g_lr_schedule=G_SCHEDULE)


@pytest.fixture(scope="module")
def restored(jax_ckpt):
    """The JAX step restored by the port: ``(state, generator, step)``; no test changes them."""
    state, gen = _port_state(), torch.Generator()
    step = checkpoint.restore_state(checkpoint.make_manager(os.path.join(jax_ckpt[0], "latest")),
                                    state, gen)
    return state, gen, step


def _named_moments(ref, which):
    """Each parameter's expected ``mu`` / ``nu`` in torch layout, by the port's parameter name."""
    s = ref["state"]
    params = {**getattr(s.g_opt_state[0], which), **getattr(s.d_opt_state[0], which)}
    return _torch_sd({"params": params, "spectral": s.spectral})


def test_jax_checkpoint_restores_bit_for_bit(jax_ckpt, restored):
    _, ref = jax_ckpt
    state, gen, step = restored
    s = ref["state"]
    assert step == state.step == STEP
    want = _torch_sd({k: getattr(s, k) for k in ("params", "batch_stats", "spectral")})
    got = state.model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    mu, nu = _named_moments(ref, "mu"), _named_moments(ref, "nu")
    g, d = training.split_params(state.model)
    for opt, names in ((state.g_opt, list(g)), (state.d_opt, list(d))):
        for i, name in enumerate(names):
            entry = opt.state_dict()["state"][i]
            assert torch.equal(entry["exp_avg"], mu[name]), name
            assert torch.equal(entry["exp_avg_sq"], nu[name]), name
            assert float(entry["step"]) == STEP
    assert state.g_sched.last_epoch == state.d_sched.last_epoch == STEP
    schedule = training.make_lr_schedule(state.g_sched.base_lrs[0], G_SCHEDULE)
    assert state.g_opt.param_groups[0]["lr"] == schedule(STEP)
    assert state.d_opt.param_groups[0]["lr"] == state.d_sched.base_lrs[0]
    assert gen.initial_seed() == checkpoint.seed_from_key(ref["key"]) == int(ref["key"][1])


def test_adam_update_from_a_jax_checkpoint_matches_optax(jax_ckpt, restored):
    """The restored moments, step and lr, one Adam step in float64, against optax's update."""
    from skillful_nowcasting_tpu.hub.export import _invert_weight

    _, ref = jax_ckpt
    state = restored[0]
    paths = param_paths(state.model)

    def f64_torch(tree):  # float64 leaves in torch layout (export_torch_state_dict casts to f32)
        out = {}
        for name, path in paths.items():
            leaf = tree
            for k in path:
                leaf = leaf[k]
            leaf = np.asarray(leaf, np.float64)
            out[name] = torch.from_numpy(np.array(_invert_weight(leaf) if path[-1] == "kernel"
                                                  else leaf))
        return out

    grads, want = f64_torch(ref["grads"]), f64_torch(ref["updated"])
    g, d = training.split_params(state.model)
    for opt, named in ((state.g_opt, g), (state.d_opt, d)):
        params = {n: p.detach().double().clone() for n, p in named.items()}
        adam = torch.optim.Adam(params.values(), lr=opt.param_groups[0]["lr"],
                                betas=opt.param_groups[0]["betas"], eps=1e-8)
        sd = adam.state_dict()
        # Copies: Adam advances its step tensor in place, and the restored state is shared.
        sd["state"] = {i: {k: (v.double() if k != "step" else v.clone()) for k, v in st.items()}
                       for i, st in opt.state_dict()["state"].items()}
        adam.load_state_dict(sd)
        for n, p in params.items():
            p.grad = grads[n].double()
        adam.step()
        for n, p in params.items():
            err = (p - want[n].double()).abs().max().item()
            assert err <= 1e-12 * want[n].double().abs().max().item(), (n, err)


def test_port_checkpoint_is_read_by_jax_restore_state(jax_ckpt, restored, tmp_path):
    """JAX -> port -> save_jax_state -> JAX restore_state: every leaf back bit for bit."""
    from skillful_nowcasting_tpu import checkpoint as jckpt

    _, ref = jax_ckpt
    state, gen, _ = restored
    manager = checkpoint.make_manager(str(tmp_path / "rt"))
    size = checkpoint.save_jax_state(manager, STEP, state, gen, {"train/g_loss": 0.5})
    assert size > 0 and manager.kind(STEP) == "orbax"
    template = jax.tree.map(lambda a: jax.device_put(np.zeros_like(a)), ref["state"])
    got, rng, step = jckpt.restore_state(jckpt.make_manager(str(tmp_path / "rt")), template,
                                         jax.random.key(0))
    assert step == STEP
    want_leaves, want_def = jax.tree.flatten_with_path(ref["state"])
    got_leaves, got_def = jax.tree.flatten_with_path(got)
    assert want_def == got_def
    for (path, w), (_, g) in zip(want_leaves, got_leaves):
        g = np.asarray(g)
        assert g.dtype == w.dtype and g.shape == w.shape, jax.tree_util.keystr(path)
        assert np.array_equal(g.reshape(-1).view(np.uint8), np.asarray(w).reshape(-1).view(np.uint8)), \
            jax.tree_util.keystr(path)
    assert np.array_equal(np.asarray(jax.random.key_data(rng)),
                          checkpoint.key_from_generator(gen))
    # The port's own restore of its write: the same state again.
    back, gen2 = _port_state(), torch.Generator()
    checkpoint.restore_state(manager, back, gen2)
    for (k, a), b in zip(state.model.state_dict().items(), back.model.state_dict().values()):
        assert torch.equal(a, b), k
    shutil.rmtree(tmp_path / "rt")  # 136 MB


def test_best_step_agrees_with_jax(jax_ckpt, restored, tmp_path):
    from skillful_nowcasting_tpu import checkpoint as jckpt

    directory, _ = jax_ckpt
    port = checkpoint.make_manager(os.path.join(directory, "best"), monitor="train/g_loss")
    jax_best = jckpt.make_manager(os.path.join(directory, "best"), monitor="train/g_loss",
                                  keep_best=True)
    assert port.all_steps() == [STEP, BEST_STEP]
    assert port.best_step() == jckpt.best_step(jax_best) == BEST_STEP
    # The port's writes, ranked by both.
    state, gen, _ = restored
    mine = checkpoint.make_manager(str(tmp_path / "best"), max_to_keep=2, monitor="train/g_loss")
    for step, loss in ((1, 2.0), (2, 1.0), (4, 3.0)):
        checkpoint.save_jax_state(mine, step, state, gen, {"train/g_loss": loss})
    assert mine.all_steps() == [1, 2]
    jax_mine = jckpt.make_manager(str(tmp_path / "best"), monitor="train/g_loss", keep_best=True)
    assert mine.best_step() == jckpt.best_step(jax_mine) == 2
    shutil.rmtree(tmp_path / "best")  # 136 MB a step


def test_trainer_resumes_a_jax_ckpt_dir(jax_ckpt, tmp_path, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    directory, _ = jax_ckpt
    _link_tree(os.path.join(directory, "latest"), tmp_path / "ckpt" / "latest")
    model = DGMR(**TRAIN_TINY, device="cpu")
    trainer = Trainer(model, max_steps=STEP + 1, ckpt_dir=str(tmp_path / "ckpt"), ckpt_every=1,
                      log_every=1, logging_forward=False, prefetch=0, g_lr_schedule=G_SCHEDULE)
    batches = synthetic_radar_batches(batch_size=1, target_frames=2, size=64, seed=3)
    state = trainer.fit(batches)
    assert f"resumed from step {STEP}" in capsys.readouterr().err
    assert state.step == STEP + 1
    latest = checkpoint.make_manager(str(tmp_path / "ckpt" / "latest"))
    assert latest.all_steps() == [STEP, STEP + 1]
    assert latest.kind(STEP) == "orbax" and latest.kind(STEP + 1) == "torch"
    shutil.rmtree(tmp_path / "ckpt")


def test_no_fallback_both_kinds_and_missing_or_extra_leaves(jax_ckpt, tmp_path):
    directory, _ = jax_ckpt
    both = tmp_path / "both"
    _link_tree(os.path.join(directory, "latest"), both)
    torch.save({}, both / str(STEP) / checkpoint.STATE_FILE)
    with pytest.raises(ValueError, match="both"):
        checkpoint.make_manager(str(both)).all_steps()

    tree = orbax_tree.read_tree(os.path.join(directory, "latest", str(STEP)))
    params = tree["state"]["params"]
    module = next(iter(params["discriminator"]))
    state = _port_state()  # both restores raise before they load anything
    for name, edit, undo in (
            ("missing", lambda: params["discriminator"].pop(module),
             lambda value: params["discriminator"].__setitem__(module, value)),
            ("extra", lambda: params.__setitem__("stray", {"kernel": np.zeros(3, np.float32)}),
             lambda _: params.pop("stray"))):
        undo_value = edit()
        step_dir = tmp_path / "edited" / str(STEP)
        orbax_tree.write_tree(str(step_dir), tree)
        undo(undo_value)
        with pytest.raises(KeyError, match="discriminator" if name == "missing" else "stray"):
            checkpoint.restore_state(checkpoint.make_manager(str(tmp_path / "edited")), state,
                                     torch.Generator())
        shutil.rmtree(step_dir)
