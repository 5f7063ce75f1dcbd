"""Command-line flags: those of ``islam_tpu/arguments.py``, with the same
names, types and defaults, plus ``--device``.

The flags that the JAX package parses but never reads (``--project-name``,
``--train-name``, ``--train-portion``, ``--enable-mapping``,
``--vo-reverse-edge``, ``--vo-right-cam``, ``--imu-epoch``,
``--use-est-cov``) are parsed and never read here either, so the reference's
command lines (``scripts/run_*.sh``) run unchanged.  ``--bf16`` runs the
VO networks in bfloat16, ``--scan-chunk K`` runs a training epoch K windows
at a time through ``train.train_scan``, and ``--profile-dir`` writes a
``torch.profiler`` trace of the second window."""

import argparse
import ast


def get_args(argv=None):
    parser = argparse.ArgumentParser(description='islam_tpu_torch')
    parser.add_argument('--batch-size', type=int, default=1)
    parser.add_argument('--worker-num', type=int, default=1,
                        help='>= 1 prepares the next window on a worker '
                             'thread (on hosts with more than one core)')
    parser.add_argument('--vo-model-name', default='',
                        help='reference .pkl for the full VONet')
    parser.add_argument('--pose-model-name', default='',
                        help='reference .pkl overriding the pose head')
    parser.add_argument('--imu-denoise-model-name', default='',
                        help='reference .pkl of the IMU denoiser')
    parser.add_argument('--data-root', default='',
                        help='sequence folder for --data-type tartanair, '
                             'kitti or euroc')
    parser.add_argument('--start-frame', type=int, default=0)
    parser.add_argument('--end-frame', type=int, default=-1)
    parser.add_argument('--save-model-dir', default='',
                        help='save {dir}/{epoch}/ after every epoch; with '
                             '--start-epoch N, resume from the newest k < N')
    parser.add_argument('--start-epoch', type=int, default=1)
    parser.add_argument('--train-epoch', type=int, default=10)
    parser.add_argument('--lr', type=float, default=1e-4)
    parser.add_argument('--imu-lr', type=float, default=3e-5)
    parser.add_argument('--vo-optimizer', default='adam',
                        choices=['adam', 'rmsprop', 'sgd'])
    parser.add_argument('--fix-model-parts', default=[], nargs='+')
    parser.add_argument('--print-interval', type=int, default=1)
    parser.add_argument('--snapshot-interval', type=int, default=1000)
    parser.add_argument('--project-name', default='')
    parser.add_argument('--train-name', default='')
    parser.add_argument('--result-dir', default='')
    parser.add_argument('--loss-weight', default='(1,1,1,1)')
    parser.add_argument('--data-type', default='tartanair',
                        choices=['tartanair', 'kitti', 'euroc', 'synthetic'])
    parser.add_argument('--rot-w', type=float, default=1)
    parser.add_argument('--trans-w', type=float, default=1)
    parser.add_argument('--use-gt-scale', action='store_true', default=False,
                        help='scale the VO translations by the ground '
                             'truth instead of stereo')
    parser.add_argument('--image-height', type=int, default=448,
                        help='input crop height (default 448)')
    parser.add_argument('--image-width', type=int, default=640,
                        help='input crop width (default 640)')
    parser.add_argument('--synthetic-frames', type=int, default=33,
                        help='frames for --data-type synthetic')
    parser.add_argument('--eval-only', action='store_true', default=False,
                        help='inference: one forward+PVGO pass over the '
                             'trajectory (no gradients, no updates), '
                             'snapshots to {result-dir}/0')
    parser.add_argument('--reproj-points', type=int, default=0,
                        help='nonzero adds the dense reprojection factor to '
                             'PVGO, weighted by loss_weight[4] (default 1)')
    parser.add_argument('--bilevel', default='detached',
                        choices=['detached', 'implicit', 'unrolled'],
                        help="the upper level's gradient: 'detached' (the "
                             "reference's: the PVGO solution is a constant), "
                             "'implicit' (implicit function theorem at the "
                             "solution) or 'unrolled' (through 5 damped "
                             "Gauss-Newton steps)")
    parser.add_argument('--frozen-bn-eval', action='store_true',
                        default=False,
                        help='run the StereoNet BatchNorms on their running '
                             'stats; only when stereo is in '
                             '--fix-model-parts')
    # parsed and never read, as in the JAX package
    parser.add_argument('--train-portion', type=float, default=1)
    parser.add_argument('--enable-mapping', action='store_true', default=False)
    parser.add_argument('--vo-reverse-edge', action='store_true',
                        default=False)
    parser.add_argument('--vo-right-cam', action='store_true', default=False)
    parser.add_argument('--imu-epoch', type=int, default=50)
    parser.add_argument('--use-est-cov', action='store_true', default=False)
    parser.add_argument('--profile-dir', default='',
                        help='write a torch.profiler trace of the second '
                             'window into this directory')
    parser.add_argument('--bf16', action='store_true', default=False,
                        help='run the VO networks in bfloat16')
    parser.add_argument('--scan-chunk', type=int, default=0,
                        help="run 'vo' and 'imu' epochs K windows at a time "
                             "with no host work between them (0/1 = "
                             "window by window)")
    parser.add_argument('--device', default='cuda',
                        help="torch device to run on ('cuda' or 'cpu')")
    args = parser.parse_args(argv)
    args.loss_weight = tuple(ast.literal_eval(args.loss_weight))
    return args
