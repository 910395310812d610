"""Root pytest configuration: build the JAX package's native extension once, before any
xdist worker starts, so that workers never race to compile the same shared library
(a worker that loads it while another writes it would skip every native test)."""


def pytest_configure(config):
    if not hasattr(config, "workerinput"):  # the controller, or a run without xdist
        import speechless_tpu.native  # noqa: F401  (builds _speechless_native.so if missing)
