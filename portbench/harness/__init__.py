"""The benchmark's harness: traffic, the closed loop, taps, the device
trace, the kernels' work and the comparison with the reference."""
