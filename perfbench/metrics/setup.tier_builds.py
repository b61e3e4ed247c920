"""setup.tier_builds: the program's ``tier.builds`` counter at the run's end:
how many times ``Runner._tier_cached`` built a likelihood tier.  One is the
set-up's build; more means a tier was built again during the run."""

from perfbench import program_spans


def read(run):
    return program_spans.counter("tier.builds")
