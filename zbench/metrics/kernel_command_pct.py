"""Share of the commands the leaders routed in the window that rode the
kernel path, from the path accounting's ``kernel_records_total`` counter
(``KernelBackend.accounting`` over every partition)."""


def read(w):
    kernel = w.counter("zeebe_kernel_records_total", path="kernel")
    total = kernel + w.counter("zeebe_kernel_records_total", path="host")
    return 100.0 * kernel / total if total else None
