"""The sparse point lists: each camera's kept points after dropping a
point whose successor lands on the same pixel, 4 bytes each, and a 4-byte
count per camera, written once."""


def work(kept, eff, size):
    return 4 * sum(eff) + 4 * len(kept), 0
