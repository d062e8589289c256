"""Plain PyTorch reference of the path tracer: the scene arrays, the
counter RNG, the camera, the nearest hit (a dense sweep, or a walk of the
benchmark's own SAH tree), the BSDF sampling and the estimator, written
again from the course's semantics. It imports neither JAX nor anything of
the program under test, and takes nothing the program made: only the same
scene inputs and frame seeds the benchmark hands the program."""
