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
# a load generator or a router never creates a CUDA context
if _sub == ["loadgen"]:
    from mpi_knn_tpu_torch.frontend.cli import loadgen_main

    sys.exit(loadgen_main(sys.argv[2:]))
if _sub == ["router"]:
    from mpi_knn_tpu_torch.frontend.cli import router_main

    sys.exit(router_main(sys.argv[2:]))
# the planner and the lint route here too (the lint imports torch only
# when it runs its matrix; ``lint --host`` never does)
if _sub == ["plan"]:
    from mpi_knn_tpu_torch.plan import main as _plan

    sys.exit(_plan(sys.argv[2:]))
if _sub == ["lint"]:
    from mpi_knn_tpu_torch.analysis.cli import main as _lint

    sys.exit(_lint(sys.argv[2:]))

from mpi_knn_tpu_torch.cli import main  # noqa: E402

sys.exit(main())
