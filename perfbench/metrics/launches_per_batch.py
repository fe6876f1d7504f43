"""launches_per_batch (count): the port's kernel launches
(``kernels/cuda.py::LAUNCHES``) in the window over the batches run."""


def read(run):
    launches = (sum(run.after["launches"].values())
                - sum(run.before["launches"].values()))
    batches = sum(t["batches"] - run.before["tenants"][n]["batches"]
                  for n, t in run.after["tenants"].items())
    return launches / batches if batches else None
