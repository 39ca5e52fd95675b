"""AxBench-style applications of the paper's application-level evaluation
(counterpart of ``repro.apps``)."""
from . import blackscholes, fft, inversek2j, jmeint, jpeg, kmeans, sobel
from .common import AxApp, evaluate, smooth_image, tune_app
from .ssim import ssim

ALL_APPS = {
    m.APP.name: m.APP
    for m in (blackscholes, fft, inversek2j, jmeint, kmeans, sobel, jpeg)
}

__all__ = ["AxApp", "evaluate", "tune_app", "smooth_image", "ssim", "ALL_APPS"]
