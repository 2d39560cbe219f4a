"""setup_s: process start to the first timed step (host clock): imports,
the kernel library's load (and build, in a checkout's first run), the
channel's precharacterization, the inputs, onboarding and the warm steps."""


def read(ctx):
    return ctx.setup_s
