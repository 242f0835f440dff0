"""Likelihood of the PyTorch port: exact NLL, NELBO and the residual."""

from .likelihood import (get_div_fn, get_elbo_fn, get_likelihood_fn,
                         get_likelihood_residual_fn, get_ode_fn)

__all__ = ["get_div_fn", "get_elbo_fn", "get_likelihood_fn",
           "get_likelihood_residual_fn", "get_ode_fn"]
