"""Command line of the port (the flags of the repository's main.py):

    python -m speech_enhancement_torch --config configs/dccrn_vbd.yaml \
        --mode train|validation|test [--save] [--dev] [--device cpu] [--run-dir DIR]

Runs on the CUDA card unless ``--device cpu`` is given. Data-parallel
training runs one process a card, with ``parallel.data: N`` in the YAML:

    torchrun --standalone --nproc_per_node N -m speech_enhancement_torch \
        --config <yaml> --mode train

(each process joins the NCCL group from torchrun's environment and trains
on ``cuda:LOCAL_RANK``; rank 0 writes the run dir).
"""

import argparse


def cli(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="python -m speech_enhancement_torch",
                                     description="speech_enhancement_torch")
    parser.add_argument("--config", default="configs/dccrn_vbd.yaml")
    parser.add_argument("--mode", default="train", choices=["train", "validation", "test"])
    parser.add_argument("--save", action="store_true", help="write enhanced wavs at test")
    parser.add_argument("--dev", action="store_true",
                        help="evaluate on the Clarity dev scenes (reference train.py:20)")
    parser.add_argument("--device", default=None,
                        help="torch device (e.g. cpu); default cuda, which needs a card")
    parser.add_argument("--run-dir", default=None)
    args = parser.parse_args(argv)

    from speech_enhancement_torch.main import main

    main(args.config, mode=args.mode, save=args.save, dev=args.dev, device=args.device,
         run_dir=args.run_dir)


if __name__ == "__main__":
    cli()
