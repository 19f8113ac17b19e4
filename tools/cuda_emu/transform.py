"""Rewrite a CUDA source of ``src/repro_torch/csrc`` for the CPU emulation.

    python3 tools/cuda_emu/transform.py SRC.cu OUT.cpp

Includes ``emu_runtime.h`` in place of ``cuda_runtime.h``, drops the inline
PTX helpers that the header emulates (``cp_async*``, ``mma_f64``), turns
shared-memory declarations into the emulated block's buffers and each
``kernel<<<grid, block, smem, stream>>>(args)`` into
``emu_launch(grid, block, smem, stream, [=] { kernel(args); })``.
"""
import re
import sys


def transform(s: str) -> str:
    s = s.replace('#include <cuda_runtime.h>', '#include "emu_runtime.h"')
    for name in ('cp_async4', 'cp_async16', 'cp_async_commit', 'mma_f64'):
        s = re.sub(r'__device__ __forceinline__ void ' + name + r'\(.*?\n}\n', '', s, count=1,
                   flags=re.S)
    s = re.sub(r'template <int N>\n__device__ __forceinline__ void cp_async_wait\(\).*?\n}\n', '',
               s, count=1, flags=re.S)
    s = re.sub(r'extern __shared__ __align__\(16\) float (\w+)\[\];',
               r'float* \1 = reinterpret_cast<float*>(emu_ctx->dyn);', s)
    s = re.sub(r'__shared__ (\w+) (\w+)((?:\[[^\]]+\])+);',
               r'auto& \2 = *reinterpret_cast<\1(*)\3>(emu_ctx->stat);', s)
    s = re.sub(r'(\w+(?:<[^<>]*>)?)<<<(.*?)>>>\((.*?)\);',
               lambda m: f'emu_launch({m.group(2)}, [=]{{ {m.group(1)}({m.group(3)}); }});',
               s, flags=re.S)
    if 'asm' in s or '__shared__' in s:
        raise ValueError("the source has PTX or shared memory the emulation does not know")
    return s


if __name__ == "__main__":
    with open(sys.argv[1]) as f:
        out = transform(f.read())
    with open(sys.argv[2], "w") as f:
        f.write(out)
