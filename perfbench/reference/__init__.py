"""The plain reference the benchmark holds the program to.

Plain PyTorch and NumPy, importing nothing of the program: the same
semantics as the renderer's progressive path tracer (the pcg4d sample
stream, env NEE with MIS, the layered metallic-roughness BSDF, the
alpha-MASK retries, the luminance clamp, the running mean and the AgX u8
frame), worked out again from the scene the benchmark generated and the
sky it drew. Ray casts go through a binary BVH of its own (bvh.py).
"""
