"""Plain references that judge the answers of a benchmark run.

Each module here is named by a traffic file's ``check`` key and exposes
``judge(pools, samples, setup) -> {number: value}``.  A reference imports
torch and the standard library only: nothing of the program under test,
and it takes nothing the program made but the answers it judges.  Every
reference works in float64 on the answers' device, so TF32 never reaches
it.
"""
