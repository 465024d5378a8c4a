// The emulated dynamic shared memory (blocks run one at a time).
#include "cuda_runtime.h"

alignas(16) unsigned char te_smem[emu::kSmemBuffer];
