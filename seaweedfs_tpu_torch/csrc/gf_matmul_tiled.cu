// The GF(2^8) apply kernel of gf_matmul.cu with the tiled loop: each thread
// handles tile / 2048 chunks, 2048 B apart, per grid-stride step.
// ops/gf_cuda.py launches it for every tile but the default (2048), which
// gf_matmul.cu's untiled kernels take; see there for the kernel and why
// the two loops are two libraries.
#define GF_TILED 1
#include "gf_matmul.cu"
