"""One rank of a launch of the port's CLI, for the multi-process tests:

    python tests/torch_dp_worker.py <timeout_s> <cli arguments...>

runs ``colbert_tpu_torch.cli.main(<cli arguments>)`` with the process
group's timeout set to ``timeout_s`` (every collective fails after it) and
one intra-op thread (the tests run beside other workers).
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

torch.set_num_threads(1)

from colbert_tpu_torch.parallel import mesh  # noqa: E402

mesh.DIST_TIMEOUT_S = float(sys.argv[1])

from colbert_tpu_torch.cli import main  # noqa: E402

main(sys.argv[2:])
