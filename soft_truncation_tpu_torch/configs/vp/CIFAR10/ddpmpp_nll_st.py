"""vp/CIFAR10/ddpmpp_nll_st.py: a copy of the JAX package's flagship config."""

from soft_truncation_tpu_torch.configs.base import default_config, override


def get_config():
  config = default_config('cifar10')
  return override(config, {
      'training': dict(
          k=1.0,
          likelihood_weighting=False,
          reduce_mean=True,
          sde='vpsde',
          st=True,
      ),
      'sampling': dict(
          corrector='none',
          method='ode',
          predictor='euler_maruyama',
      ),
      'data': dict(
          centered=True,
      ),
      'model': dict(
          attention_type='ddpm',
          attn_resolutions=(16,),
          ch_mult=(1, 2, 2, 2),
          conditional=True,
          conv_size=3,
          ema_rate=0.9999,
          embedding_type='positional',
          fir=False,
          fir_kernel=[1, 3, 3, 1],
          fourier_scale=16,
          init_scale=0.0,
          name='ncsnpp',
          nf=128,
          nonlinearity='swish',
          normalization='GroupNorm',
          num_res_blocks=4,
          progressive='none',
          progressive_combine='sum',
          progressive_input='none',
          resamp_with_conv=True,
          resblock_type='biggan',
          scale_by_sigma=False,
          skip_rescale=True,
      ),
  })
