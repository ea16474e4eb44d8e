"""`osg_decode`'s share of its byte bound in the EG3D step: the sum over the
window's launches of each launch's bound at its own shape (4 a step at
N=4, M=64^2 x 48: Gmain's and Dmain's coarse and fine passes; one a Greg at
N=4, M=2,000), over the kernel's device time. None when the trace's
launches are not the ones counted."""


def read(r):
    device_s, launches = r["trace"].kernel_s("osg_decode")
    if not launches or device_s <= 0 or launches != r["decoder_launches"]:
        return None
    return 100.0 * r["decoder_bound_total_s"] / device_s
