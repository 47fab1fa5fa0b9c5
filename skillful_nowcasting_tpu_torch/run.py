"""Train DGMR with the port: ``python -m skillful_nowcasting_tpu_torch.run``.

The counterpart of ``train/run.py``, with the same flags. The model trains
on the card unless ``--device cpu``. Data come from one of:

* ``--synthetic`` (``--synthetic-kind noise | radar | radar-device``);
* ``--nimrod-parquet FILE...``: local parquet files of the nimrod-uk-1km
  schema (``radar_frames``), streamed through ``NimrodStream``;
* ``--mrms-npy FILE``: a ``(T, H, W)`` or ``(T, H, W, C)`` ``.npy`` radar
  array (memory-mapped), cropped by ``MRMSSequences``;
* ``--dataset-name NAME``: a hub dataset, e.g. ``openclimatefix/nimrod-uk-1km``
  (needs the network and ``datasets``).

A run with ``--ckpt-dir`` resumes from its ``latest/`` checkpoint; SIGTERM
saves one first. Examples::

    python -m skillful_nowcasting_tpu_torch.run --synthetic --synthetic-kind radar-device \\
        --batch-size 2 --max-steps 1000 --compute-dtype bfloat16 --r1-gamma 10
    python -m skillful_nowcasting_tpu_torch.run --nimrod-parquet data/*.parquet --ckpt-dir ckpts

Data parallelism: launch one process per card with ``torchrun``, e.g.
``torchrun --nproc-per-node 4 -m skillful_nowcasting_tpu_torch.run ...``.
``--batch-size`` stays the global batch (each rank takes ``batch / ranks``
rows, and must get a whole number), each rank streams its own shard of the
data, ``--dp-mode`` picks the step's semantics (:mod:`.parallel.dp`) and
only rank 0 writes checkpoints and logs. NCCL needs a card per rank;
``--dist-backend gloo --device cuda:0`` runs several ranks on one card.
``--mesh-space N`` (with ``--dp-mode pjit``) shards each field's H over N
ranks as well: the ranks of a space group read their data rank's batch and
each trains on its stripe (``--output-shape`` must divide by ``32 N``).
"""

from __future__ import annotations

import argparse
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train DGMR (PyTorch port)")
    p.add_argument("--batch-size", type=int, default=16)  # reference run.py:182
    p.add_argument("--max-steps", type=int, default=100_000)
    p.add_argument("--forecast-steps", type=int, default=18)
    p.add_argument("--output-shape", type=int, default=256)
    p.add_argument("--generation-steps", type=int, default=6)
    p.add_argument("--latent-channels", type=int, default=768)
    p.add_argument("--context-channels", type=int, default=384)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--ckpt-dir", default="./checkpoints")
    p.add_argument("--ckpt-every", type=int, default=100)
    p.add_argument("--log-dir", default="./tb_logs",
                   help="metrics.jsonl, and TensorBoard events where tensorboard imports; "
                        "'none' logs to stdout only")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--val-every", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--visualize", action="store_true")
    p.add_argument("--synthetic", action="store_true", help="synthetic data instead of a dataset")
    p.add_argument("--synthetic-kind", choices=["noise", "radar", "radar-device"], default="noise",
                   help="noise = i.i.d. uniform; radar = advecting Gaussian rain cells "
                        "(learnable); radar-device = the same rendered on the device")
    p.add_argument("--nimrod-parquet", nargs="+", metavar="FILE",
                   help="local nimrod-uk-1km parquet files (train and validation)")
    p.add_argument("--mrms-npy", metavar="FILE", help="a (T, H, W[, C]) radar array as .npy")
    p.add_argument("--dataset-name", default=None,
                   help="hub dataset for NimrodStream, e.g. openclimatefix/nimrod-uk-1km "
                        "(needs the network)")
    p.add_argument("--transfer-dtype", choices=["float32", "bfloat16"], default="float32",
                   help="dtype host batches go to the device in; bfloat16 halves the bytes "
                        "(quantizes inputs — see data/prefetch.py)")
    p.add_argument("--no-logging-forward", action="store_true",
                   help="drop the reference's unused extra generator forward (quirk Q8)")
    p.add_argument("--watch-gradients", action="store_true",
                   help="log per-layer gradient norms (reference wandb.watch, run.py:37-49)")
    p.add_argument("--watch-histograms", action="store_true",
                   help="log per-layer parameter and gradient histograms (symlog bins)")
    p.add_argument("--val-skill", action="store_true",
                   help="log CRPS/CSI/MSE skill metrics at each validation")
    p.add_argument("--compute-dtype", choices=["float32", "bfloat16"], default="float32",
                   help="bfloat16 = mixed precision (f32 parameters, moments, BN/SN state)")
    p.add_argument("--remat", choices=["rollout", "none"], default="rollout",
                   help="rollout = recompute each G rollout in the backward pass (less memory); "
                        "none = keep its activations")
    p.add_argument("--resume-lightning", default=None, metavar="CKPT",
                   help="initialize from a reference Lightning .ckpt (weights, optimizers, step)")
    p.add_argument("--g-lr-schedule", default=None, metavar="SPEC",
                   help="opt-in generator LR schedule (training.make_lr_schedule): "
                        "cosine:STEPS[:ALPHA] | exp:STEPS:RATE | "
                        "warmup_cosine:WARM:STEPS[:ALPHA] | linear:STEPS[:END]")
    p.add_argument("--d-lr-schedule", default=None, metavar="SPEC",
                   help="opt-in discriminator LR schedule (same specs)")
    p.add_argument("--r1-gamma", type=float, default=0.0,
                   help="R1 gradient penalty weight on D's real scores (0 = reference-exact)")
    p.add_argument("--no-abort-on-nan", action="store_true",
                   help="keep training through non-finite logged metrics")
    p.add_argument("--dp-mode", choices=["shard_map", "pjit"], default="shard_map",
                   help="data-parallel step (parallel/dp.py): shard_map = DDP semantics (per-rank "
                        "draws and BatchNorm statistics); pjit = the global batch's step "
                        "(synchronised BatchNorm, shared draws)")
    p.add_argument("--mesh-space", type=int, default=1,
                   help="ranks along the mesh's space axis: > 1 shards each field's H over them "
                        "(spatial_axis; needs --dp-mode pjit)")
    p.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                   help="torch.distributed backend under torchrun (default: nccl on CUDA)")
    args = p.parse_args(argv)
    sources = [args.synthetic, bool(args.nimrod_parquet), bool(args.mrms_npy),
               bool(args.dataset_name)]
    if sum(sources) != 1:
        p.error("give exactly one data source: --synthetic, --nimrod-parquet, --mrms-npy or "
                "--dataset-name")
    return args


def data_iterators(args, device, rank: int = 0, ranks: int = 1):
    """(train, validation) iterators of this rank's NTCHW batches for the chosen source.

    Each of ``ranks`` ranks takes ``args.batch_size / ranks`` rows a batch.
    Synthetic data and MRMS crops are seeded per rank and Nimrod streams
    sharded by it (:mod:`.data`). ``rank`` and ``ranks`` are the data axis',
    so the ranks of a space group read the same batches.
    """
    import numpy as np

    from .data import (
        DGMRDataModule,
        MRMSSequences,
        synthetic_batches,
        synthetic_radar_batches,
        synthetic_radar_batches_device,
    )

    if args.batch_size % ranks:
        raise ValueError(f"--batch-size {args.batch_size} does not divide over {ranks} ranks")
    batch = args.batch_size // ranks
    seed = args.seed + 7919 * rank  # MRMSSequences' per-process offset
    common = dict(batch_size=batch, target_frames=args.forecast_steps, size=args.output_shape)
    if args.synthetic:
        if args.synthetic_kind == "radar-device":
            return (synthetic_radar_batches_device(seed=seed, device=device, **common),
                    synthetic_radar_batches_device(seed=seed + 1, device=device, **common))
        gen = synthetic_batches if args.synthetic_kind == "noise" else synthetic_radar_batches
        return gen(seed=seed, **common), gen(seed=seed + 1, **common)
    if args.mrms_npy:
        array = np.load(args.mrms_npy, mmap_mode="r")
        kw = dict(batch_size=batch, crop=args.output_shape,
                  num_target_frames=args.forecast_steps)
        kw.update(process_index=rank, process_count=ranks)
        return (iter(MRMSSequences(array, seed=args.seed, **kw)),
                iter(MRMSSequences(array, seed=args.seed + 10_000, **kw)))
    if args.nimrod_parquet:
        stream = dict(dataset_name="parquet", config_name=None, load_kwargs={
            "data_files": {"train": args.nimrod_parquet, "validation": args.nimrod_parquet}})
    else:
        stream = dict(dataset_name=args.dataset_name)
    dm = DGMRDataModule(batch_size=batch, num_target_frames=args.forecast_steps,
                        seed=args.seed, process_index=rank, process_count=ranks, **stream)
    return dm.train_dataloader(), dm.val_dataloader()


def main(argv=None):
    args = parse_args(argv)
    import torch

    from . import DGMR
    from .parallel import init_distributed, make_mesh
    from .trainer import Trainer

    init_distributed(args.dist_backend)
    mesh = make_mesh(n_space=args.mesh_space,
                     device=None if args.device == "cuda" else args.device)
    print(f"mesh: {mesh.shape} rank {mesh.rank} on {mesh.device}", file=sys.stderr)
    model = DGMR(
        forecast_steps=args.forecast_steps, output_shape=args.output_shape,
        generation_steps=args.generation_steps, latent_channels=args.latent_channels,
        context_channels=args.context_channels, visualize=args.visualize, device=mesh.device,
    )
    train_iter, val_iter = data_iterators(args, mesh.device, mesh.data_rank, mesh.shape["data"])
    bf16 = {"float32": None, "bfloat16": torch.bfloat16}
    trainer = Trainer(
        model,
        max_steps=args.max_steps, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        val_every=args.val_every, log_every=args.log_every,
        log_dir=None if args.log_dir in ("", "none") else args.log_dir,
        use_wandb=args.wandb, seed=args.seed, logging_forward=not args.no_logging_forward,
        transfer_dtype=bf16[args.transfer_dtype], watch_gradients=args.watch_gradients,
        watch_histograms=args.watch_histograms, val_skill=args.val_skill,
        compute_dtype=bf16[args.compute_dtype], rollout_remat=args.remat == "rollout",
        g_lr_schedule=args.g_lr_schedule, d_lr_schedule=args.d_lr_schedule,
        r1_gamma=args.r1_gamma, abort_on_nan=not args.no_abort_on_nan,
        mesh=mesh, dp_mode=args.dp_mode, spatial_axis="space" if args.mesh_space > 1 else None,
    )
    init_state = None
    if args.resume_lightning:
        from .hub import train_state_from_lightning

        init_state, _ = train_state_from_lightning(model, args.resume_lightning)
        print(f"initialized from Lightning ckpt {args.resume_lightning} (step {init_state.step})",
              file=sys.stderr)
    return trainer.fit(train_iter, val_iter, init_state=init_state)


if __name__ == "__main__":
    main()
