"""Share of the traced window's device time in operations outside the
port's kernels K1-K6: PyTorch's own elementwise, copy, index and other
operations by ``frozen.kernel_family`` (the HCNN's int64 tap sums and
``% q``, the upload's copy), over the device time of every operation."""

from hhe_bench import frozen

PORT = ("ntt", "mont", "mod_elem", "mod_down")


def read(run):
    if run.trace is None:
        return None
    total = run.trace.device_ms(lambda name: True)
    if total <= 0:
        return None
    return 100.0 * run.trace.device_ms(lambda name: frozen.kernel_family(name) not in PORT) / total
