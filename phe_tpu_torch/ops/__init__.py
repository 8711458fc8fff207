"""Device arithmetic: limb math, Montgomery and RNS engines, CUDA kernels."""
