"""setup.build_s: the host clock around the kernel library's build or load
(``ops._build.build_library``), the first thing the run does on the card (s)."""


def read(run):
    return run.get("build_s")
