"""setup_s: seconds from the process's start to the end of set-up (imports,
the kernels' build or load, the model, weights and data made on the device,
the checked first calls, which compile and warm every shape)."""


def read(ctx):
    return ctx['setup_s']
