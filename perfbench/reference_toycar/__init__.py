"""The plain reference the benchmark holds the ToyCar-class configuration
to: perfbench/reference extended with the layers that scene needs. Its
own pathtracer.py, world.py and render.py extend that package's; the BVH,
the environment tables, the post step and the shared helpers are that
package's own modules (bvh, env, post, common), imported relatively, so
both references run the same code there.

Plain PyTorch and NumPy, importing nothing of the program: the same
semantics as the renderer's progressive path tracer (the pcg4d sample
stream, env NEE with MIS, point and spot light NEE with binary shadows,
the layered glTF BSDF with clearcoat, Charlie sheen and thin transmission,
KHR_texture_transform, Russian roulette, the luminance clamp, the running
mean and the AgX u8 frame), worked out again from the scene the benchmark
generated and the sky it drew. Ray casts go through the reference's
binary BVH (perfbench/reference/bvh.py). Float32 throughout.
"""
