"""Console entry points (pyproject [project.scripts])."""

import sys


def bench_main():
    from defl_tpu_torch.bench import main

    sys.exit(main())


def breakdown_main():
    from defl_tpu_torch.breakdown import main

    main()
