import sys

# the torch-free subcommands route before the run CLI, which imports
# torch: the doctor's supervisor never initializes the card
_sub = sys.argv[1:2]
if _sub == ["doctor"]:
    from mpi_knn_tpu_torch.resilience.doctor import main as _doctor

    sys.exit(_doctor(sys.argv[2:]))
if _sub == ["metrics"]:
    from mpi_knn_tpu_torch.obs.cli import main as _metrics

    sys.exit(_metrics(sys.argv[2:]))

from mpi_knn_tpu_torch.cli import main  # noqa: E402

sys.exit(main())
