"""Command line interface of the port:
``python3 -m s2p_tpu_torch.cli config.json [--start_from N]`` (installed
as the ``s2p_tpu_torch`` console script).  The run goes to the CUDA card;
the same arguments as the JAX package's ``s2p_tpu`` command."""

from __future__ import annotations

import argparse
import os
import shutil
import sys

from . import pipeline


def main(argv=None):
    p = argparse.ArgumentParser(
        description='S2P on an NVIDIA GPU: the PyTorch/CUDA port of the '
                    'satellite stereo pipeline')
    p.add_argument('config', metavar='config.json',
                   help='path to a json file containing the paths to '
                        'input and output files and the algorithm '
                        'parameters')
    p.add_argument('--start_from', dest='start_from', type=int, default=0,
                   help='restart the process from a given step in case of '
                        'an interruption or an update')
    args = p.parse_args(argv)
    user_cfg = pipeline.read_config_file(args.config)
    try:
        pipeline.main(user_cfg, start_from=args.start_from)
    except pipeline.runner.TimeoutError_ as e:
        # a timed-out stage may leave daemon worker threads stuck inside
        # device calls, and a normal interpreter exit then hangs or aborts
        # in the runtime's teardown: report and leave at once
        print(f'\ns2p_tpu_torch: aborted: {e}', file=sys.stderr)
        sys.stderr.flush()
        sys.stdout.flush()
        os._exit(1)

    # back up the input config inside the output directory
    try:
        shutil.copy2(args.config,
                     f"{user_cfg['out_dir']}/config.json.orig")
    except (OSError, shutil.SameFileError):
        pass


if __name__ == '__main__':
    main()
