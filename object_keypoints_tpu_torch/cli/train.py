"""Training CLI: the flags of scripts/train.py, plus ``--cpu``.

    python -m object_keypoints_tpu_torch.cli.train --train data/train --val data/val \
        --keypoints config/valve.json --batch-size 8 --lr 4e-3

Trains a KeypointNet with ``training.loop.train`` on the CUDA card (it raises
without one) unless ``--cpu`` asks for the CPU; writes metrics.jsonl,
hparams.json, the checkpoints and the serving artifact under ``--out`` and
prints the loop's result as JSON. ``--fp16`` trains in bfloat16 (float32
parameters and BatchNorm); ``--workers`` is the host pipeline's prefetch
depth.

Several processes, one a card (the JAX CLI's launch contract): run one copy
per process with ``COORDINATOR_ADDRESS=host:port NUM_PROCESSES=n
PROCESS_ID=i`` set. ``parallel.initialize_distributed`` joins them in a
process group (NCCL on the cards, gloo with ``--cpu``) and rank i trains on
``cuda:(i % device_count)``; ``--batch-size`` is per process, and rank 0
alone writes the run.
"""

import argparse
import json

from object_keypoints_tpu_torch.parallel import destroy_distributed, initialize_distributed
from object_keypoints_tpu_torch.training.loop import TrainConfig, train


def read_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--workers", "-w", type=int, default=1,
                        help="Prefetch buffer depth of the host pipeline.")
    parser.add_argument("--train", type=str, required=True, help="Path to training dataset.")
    parser.add_argument("--val", type=str, required=True, help="Path to validation dataset.")
    parser.add_argument("--fp16", action="store_true",
                        help="Half precision (bfloat16 compute, float32 parameters).")
    parser.add_argument("--pool", default=1000, type=int,
                        help="How many examples to use in shuffle pool.")
    parser.add_argument("--keypoints", default="config/cups.json",
                        help="Keypoint configuration file.")
    parser.add_argument("--batch-size", default=8, type=int)
    parser.add_argument("--weight-decay", default=0.01, type=float)
    parser.add_argument("--features", default=128, type=int,
                        help="Intermediate features in network.")
    parser.add_argument("--center-weight", default=1.0, type=float,
                        help="Weight for center loss vs. heatmap loss.")
    parser.add_argument("--depth-weight", default=10.0, type=float,
                        help="Weight for depth loss vs. heatmap loss (the reference "
                        "hard-codes 10.0).")
    parser.add_argument("--lr", default=4e-3, type=float, help="Learning rate.")
    parser.add_argument("--dropout", default=0.1, type=float)
    parser.add_argument("--resume", default=None,
                        help="Checkpoint directory whose last checkpoint to resume from.")
    parser.add_argument("--epochs", default=10, type=int)
    parser.add_argument("--out", default="runs/keypoints", help="Output/checkpoint directory.")
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--tensorboard", action="store_true",
                        help="Also write a TensorBoard event file under --out.")
    parser.add_argument("--ckpt-every", default=1, type=int,
                        help="Write the checkpoints every N epochs (the best is tracked "
                        "every epoch).")
    parser.add_argument("--cpu", action="store_true", help="Train on the CPU, not the CUDA card.")
    return parser.parse_args(argv)


def main(argv=None):
    flags = read_args(argv)
    device = "cpu" if flags.cpu else "cuda"
    # None when COORDINATOR_ADDRESS is unset; else this process's device
    joined = initialize_distributed(device=device)
    try:
        return run(flags, joined or device)
    finally:
        if joined is not None:
            destroy_distributed()


def run(flags, device):
    with open(flags.keypoints) as f:
        keypoint_config = json.load(f)["keypoint_config"]
    config = TrainConfig(
        train=flags.train,
        val=flags.val,
        keypoint_config=keypoint_config,
        batch_size=flags.batch_size,
        lr=flags.lr,
        weight_decay=flags.weight_decay,
        features=flags.features,
        center_weight=flags.center_weight,
        depth_weight=flags.depth_weight,
        dropout=flags.dropout,
        pool=flags.pool,
        epochs=flags.epochs,
        bf16=flags.fp16,
        seed=flags.seed,
        out_dir=flags.out,
        resume=flags.resume,
        ckpt_every=flags.ckpt_every,
        tensorboard=flags.tensorboard,
    )
    result = train(config, device=device, prefetch=flags.workers)
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
