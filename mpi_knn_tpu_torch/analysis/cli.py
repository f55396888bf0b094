"""``python -m mpi_knn_tpu_torch lint`` — the port's lint entry point.

``lint --host`` runs the host concurrency lint (``analysis/host/``, rules
H1–H4 over the threaded host modules). The JAX package's other lint, rules
R1–R8 over each backend's compiled XLA program, has no port yet (ROADMAP
A.5c: eager PyTorch compiles no HLO, so each rule first needs a port check
or a reasoned "no counterpart"); ``lint`` without ``--host`` is refused
with exit 2. Torch-free.
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--host" in argv:
        from mpi_knn_tpu_torch.analysis.host.cli import main as host_main

        return host_main([a for a in argv if a != "--host"])
    print("error: subcommand 'lint': not yet ported to mpi_knn_tpu_torch "
          "but for `lint --host` (the rules over compiled programs wait "
          "for ROADMAP A.5c; see ROADMAP.md)", file=sys.stderr)
    return 2
