"""ve/cifar10_uncsn_deep_1e-3_mid.py: a copy of the JAX package's config."""

from soft_truncation_tpu_torch.configs.base import default_config, override


def get_config():
  config = default_config('cifar10')
  return override(config, {
      'training': dict(
          sde='rve-sde',
      ),
      'sampling': dict(
          corrector='langevin',
          method='pc',
          predictor='reverse_diffusion',
      ),
      'model': dict(
          attention_type='ddpm',
          attn_resolutions=(16,),
          ch_mult=(1, 2, 2, 2),
          conditional=True,
          conv_size=3,
          ema_rate=0.999,
          fir=True,
          fir_kernel=[1, 3, 3, 1],
          fourier_scale=16,
          init_scale=0.0,
          name='ncsnpp',
          nf=128,
          nonlinearity='swish',
          normalization='GroupNorm',
          num_res_blocks=8,
          progressive='none',
          progressive_combine='sum',
          progressive_input='residual',
          resamp_with_conv=True,
          resblock_type='biggan',
          scale_by_sigma=True,
          sigma_min=0.001,
          skip_rescale=True,
      ),
      'uncsn': dict(
          eta=0.001,
          threshold='middle',
      ),
  })
