"""ve/celebahq/uncsnpp_st.py: a copy of the JAX package's config."""

from soft_truncation_tpu_torch.configs.base import default_config, override


def get_config():
  config = default_config('lsun')
  return override(config, {
      'training': dict(
          k=2.0,
          sde='vesde',
          snapshot_sampling=False,
          st=True,
      ),
      'sampling': dict(
          corrector='langevin',
          method='pc',
          predictor='reverse_diffusion',
      ),
      'data': dict(
          dataset='CelebAHQ',
          tfrecords_path='/data/CelebAHQ_256/celeba_r08.tfrecords',
      ),
      'model': dict(
          attention_type='ddpm',
          attn_resolutions=(16,),
          ch_mult=(1, 1, 2, 2, 2, 2, 2),
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
          num_res_blocks=2,
          progressive='output_skip',
          progressive_combine='sum',
          progressive_input='input_skip',
          resamp_with_conv=True,
          resblock_type='biggan',
          scale_by_sigma=True,
          sigma_max=348,
          skip_rescale=True,
      ),
  })
