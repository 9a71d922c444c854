"""CLI argument parser (the port's copy of ``diff3dhpe_tpu/cli/args.py``,
flag for flag) mirroring the reference's flag surface
(reference: common/arguments.py:13-105), so reference command lines from
Experiments.sh work with at most the script name changed. Booleans accept
the reference's string form ('True'/'False')."""
from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="diff3dhpe_torch training/eval")
    parser.add_argument("--config", help="config.json with training/model/data params")

    # General
    parser.add_argument("--seed", type=int)
    parser.add_argument("-d", "--dataset", type=str, metavar="NAME")
    parser.add_argument("--model", type=str, metavar="NAME")
    parser.add_argument("-k", "--keypoints", type=str, metavar="NAME")
    parser.add_argument("--train_extra_noise_std", type=float, default=0.0)
    parser.add_argument("--train_val_extra_noise_std", type=float, default=0.0)
    parser.add_argument("--test_extra_noise_std", type=float, default=0.0)
    parser.add_argument("--train_joint_drop", type=float, default=0.0)
    parser.add_argument("--train_val_joint_drop", type=float, default=0.0)
    parser.add_argument("--test_joint_drop", type=float, default=0.0)
    parser.add_argument("-str", "--subjects-train", type=str, metavar="LIST")
    parser.add_argument("-ste", "--subjects-test", type=str, metavar="LIST")
    parser.add_argument("-a", "--actions", type=str, metavar="LIST")
    parser.add_argument("-c", "--checkpoint", default="checkpoint", type=str, metavar="PATH")
    parser.add_argument("--checkpoint-frequency", default=40, type=int, metavar="N")
    parser.add_argument("-r", "--resume", default="", type=str, metavar="FILENAME")
    parser.add_argument("--pretrained_model", default=None, type=str, metavar="PATH")
    parser.add_argument("--workers", type=int, default=0)
    parser.add_argument("--evaluate", default="", type=str, metavar="FILENAME")
    parser.add_argument("--by-subject", action="store_true")
    parser.add_argument("--export-training-curves", action="store_true")
    parser.add_argument("--gpu_id", nargs="+", help="accepted for CLI compat; ignored (the port runs on one CUDA device)")
    parser.add_argument("--out_all")
    parser.add_argument("--repeat_n", type=int)

    # Model / training
    parser.add_argument("-s", "--stride", type=int, metavar="N")
    parser.add_argument("-e", "--epochs", type=int, metavar="N")
    parser.add_argument("-b", "--batch-size", type=int, metavar="N")
    parser.add_argument("--batch-size-eval", type=int, metavar="N")
    parser.add_argument("-lr", "--learning-rate", type=float, metavar="LR")
    parser.add_argument("-lrd", "--lr-decay", type=float, metavar="LR")
    parser.add_argument("--patience", type=int, metavar="N")
    parser.add_argument("--timesteps", type=int)
    parser.add_argument("--sampling_timesteps", type=int)
    parser.add_argument("--data-augmentation")
    parser.add_argument("--test-time-augmentation")
    parser.add_argument("-frame", "--number-of-frames", type=int, metavar="N")
    parser.add_argument("--transformer_depth", type=int, metavar="N")
    parser.add_argument("--clip_denoised")
    parser.add_argument("--with_time_emb")
    parser.add_argument("--beta_schedule", default=None, type=str)
    parser.add_argument("--embed_dim", type=int, metavar="N")
    parser.add_argument("--ddim_sampling_eta", default=None, type=float, metavar="FACTOR")
    parser.add_argument("--loss_type", default=None, type=str)
    parser.add_argument("--max_time", default=None, type=float)
    parser.add_argument("--clip_loss")
    parser.add_argument("--subset", default=None, type=float, metavar="FRACTION")
    parser.add_argument("--downsample", default=None, type=int, metavar="FACTOR")
    parser.add_argument("--no-eval", action="store_true")

    # Extensions of the JAX package, kept flag for flag
    parser.add_argument("--mesh-shape", type=str, default=None,
                        help="JAX device mesh; the port runs on one device")
    parser.add_argument("--matmul-precision", type=str, default=None,
                        choices=["highest", "default", "bfloat16"])
    parser.add_argument("--compute-dtype", type=str, default=None,
                        choices=["float32", "bfloat16"])
    parser.add_argument("--data-root", type=str, default=None)
    parser.add_argument("--synthetic", action="store_true",
                        help="run on generated synthetic data (smoke/demo)")
    parser.add_argument("--synthetic-motion", type=str, default="walk",
                        choices=["walk", "latent"],
                        help="synthetic motion model: 'walk' (unstructured, "
                             "pipeline coverage) or 'latent' (learnable "
                             "manifold motion for convergence studies)")
    parser.add_argument("--num-heads", type=int, default=None, metavar="N",
                        help="attention heads (default 8 = reference geometry;"
                             " the CUDA kernels take head_dim 64)")
    parser.add_argument("--fast-eval", action="store_true",
                        help="fused-kernel inference path for evaluation")
    parser.add_argument("--fast-train", action="store_true",
                        help="fused-kernel training forward (custom VJP)")
    parser.add_argument("--eval-f32-final-steps", type=int, default=None,
                        metavar="N",
                        help="mixed-precision fast eval: run the last N DDIM"
                             " steps through the f32 fused forward (with"
                             " --fast-eval --compute-dtype bfloat16)")
    parser.add_argument("--eval-f32-head", action="store_true",
                        help="keep the bf16 fast-eval head epilogue in f32")
    parser.add_argument("--eval-final-prec", type=str, default=None,
                        choices=["default", "high3", "highest"],
                        help="f32 contraction mode of the final f32 DDIM"
                             " steps; high3 and highest both mean exact f32")
    parser.add_argument("--eval-f32-tail-pairs", type=int, default=None,
                        metavar="K",
                        help="inside the final f32 DDIM step(s), run only"
                             " the last K block pairs + head at f32 (earlier"
                             " pairs stay bf16); 0 = whole step f32")
    return parser


def args_to_overrides(args) -> dict:
    """argparse namespace -> Config override dict (None values dropped by
    load_config, matching the reference's merge rule)."""
    mapping = dict(
        seed=args.seed, dataset=args.dataset, model=args.model, keypoints=args.keypoints,
        subjects_train=args.subjects_train, subjects_test=args.subjects_test,
        actions=args.actions, stride=args.stride, timesteps=args.timesteps,
        sampling_timesteps=args.sampling_timesteps, epochs=args.epochs,
        batch_size=args.batch_size, batch_size_eval=args.batch_size_eval,
        learning_rate=args.learning_rate, lr_decay=args.lr_decay,
        data_augmentation=args.data_augmentation,
        test_time_augmentation=args.test_time_augmentation,
        number_of_frames=args.number_of_frames, out_all=args.out_all,
        transformer_depth=args.transformer_depth, clip_denoised=args.clip_denoised,
        with_time_emb=args.with_time_emb, patience=args.patience,
        ddim_sampling_eta=args.ddim_sampling_eta, embed_dim=args.embed_dim,
        beta_schedule=args.beta_schedule, max_time=args.max_time,
        pretrained_model=args.pretrained_model, clip_loss=args.clip_loss,
        checkpoint=args.checkpoint, checkpoint_frequency=args.checkpoint_frequency,
        resume=args.resume or None, evaluate=args.evaluate or None,
        repeat_n=args.repeat_n, subset=args.subset, downsample=args.downsample,
        num_heads=args.num_heads,
        mesh_shape=args.mesh_shape, matmul_precision=args.matmul_precision,
        compute_dtype=args.compute_dtype, data_root=args.data_root,
        loss_type=args.loss_type,
        train_extra_noise_std=args.train_extra_noise_std,
        test_extra_noise_std=args.test_extra_noise_std,
        train_joint_drop=args.train_joint_drop,
        test_joint_drop=args.test_joint_drop,
        no_eval=args.no_eval or None,
        export_training_curves=args.export_training_curves or None,
        fast_eval=args.fast_eval or None,
        fast_train=args.fast_train or None,
        eval_f32_final_steps=args.eval_f32_final_steps,
        eval_f32_head=args.eval_f32_head or None,
        eval_final_prec=args.eval_final_prec,
        eval_f32_tail_pairs=args.eval_f32_tail_pairs,
    )
    return mapping
