"""Mean luma PSNR of the pool's frames against their recons, worked out
after the window."""


def read(run):
    return run.psnr_y
