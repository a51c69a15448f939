"""host_build_s: host seconds from the scene's build to a constructed
renderer (the scene's host arrays, the environment, the port's
acceleration structure, light table and device tables)."""


def read(ctx):
    return ctx.host_build_s
