"""vp/CIFAR10/ddpmpp_fid_st_deepest.py: a copy of the JAX package's config."""

from soft_truncation_tpu_torch.configs.base import default_config, override


def get_config():
  config = default_config('cifar10')
  return override(config, {
      'training': dict(
          ddpm_weight=100.0,
          importance_sampling=False,
          k=0.9,
          likelihood_weighting=False,
          mixed=True,
          reduce_mean=True,
          sde='vpsde',
          st=True,
      ),
      'sampling': dict(
          corrector='none',
          method='pc',
          predictor='euler_maruyama',
      ),
      'data': dict(
          centered=True,
      ),
      'model': dict(
          attention_type='ddpm',
          attn_resolutions=(16,),
          ch_mult=(1, 1, 1),
          conditional=True,
          conv_size=3,
          dropout=0.2,
          ema_rate=0.9999,
          embedding_dim=128,
          embedding_type='positional',
          fir=True,
          fir_kernel=[1, 3, 3, 1],
          fourier_scale=16,
          init_scale=0.0,
          lsgm=True,
          name='ncsnpp',
          nf=512,
          nonlinearity='swish',
          normalization='GroupNorm',
          num_res_blocks=8,
          progressive='none',
          progressive_combine='sum',
          progressive_input='none',
          resamp_with_conv=True,
          resblock_type='biggan',
          scale_by_sigma=False,
          skip_rescale=True,
      ),
  })
