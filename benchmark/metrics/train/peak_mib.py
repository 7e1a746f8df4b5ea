"""Peak device memory of the run (`torch.cuda.max_memory_allocated`),
read before the reference runs, in MiB."""
from benchmark.readings import peak_mib


def read(rec):
    return peak_mib(rec, "train")
