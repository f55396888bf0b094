import sys

from mpi_knn_tpu_torch.cli import main

sys.exit(main())
