"""In-the-wild (COCO-layout 2D keypoints) H36M train and evaluate entry point.

    python -m d3dp_tpu_torch.cli.main_in_the_wild -k detectron_pt_coco ...

Counterpart of the root main_in_the_wild.py of the JAX package: the H36M
command line (cli/main_h36m.py) with the in-the-wild training defaults
(`parse_args(in_the_wild=True)`: stride 1, 120 epochs, lr 4e-5, lrd 0.99)
and Protocol-2 always reported. Direct video inference is
`d3dp_tpu_torch.in_the_wild.inference_video`. Runs on the card unless
`--platform cpu`.
"""

from d3dp_tpu_torch.cli import main_h36m
from d3dp_tpu_torch.cli.arguments import launch, parse_args


def main(argv=None):
    args = parse_args(argv, in_the_wild=True)
    args.p2 = True  # the reference main_in_the_wild.py always reports P2
    return launch(main_h36m.run_with_args, args)


if __name__ == "__main__":
    main()
