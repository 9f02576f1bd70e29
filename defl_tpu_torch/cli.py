"""Console entry points (pyproject [project.scripts])."""


def breakdown_main():
    from defl_tpu_torch.breakdown import main

    main()
