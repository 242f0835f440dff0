"""ve/ffhq_1024_uncsn.py: a copy of the JAX package's config."""

from soft_truncation_tpu_torch.configs.base import default_config, override


def get_config():
  config = default_config('cifar10')
  return override(config, {
      'training': dict(
          batch_size=16,
          likelihood_weighting=False,
          log_freq=50,
          n_iters=240000001,
          reduce_mean=True,
          sde='rve-sde',
          snapshot_freq=50000,
          snapshot_freq_for_preemption=5000,
          snapshot_sampling=True,
      ),
      'sampling': dict(
          corrector='langevin',
          method='pc',
          predictor='reverse_diffusion',
          snr=0.15,
      ),
      'eval': dict(
          batch_size=40,
          begin_ckpt=1,
          enable_loss=False,
          enable_sampling=True,
          end_ckpt=96,
      ),
      'data': dict(
          dataset='FFHQ',
          image_size=1024,
          tfrecords_path='/downloaded_data/FFHQ_1024/ffhq-r10.tfrecords',
          uniform_dequantization=False,
      ),
      'model': dict(
          attention_type='ddpm',
          attn_resolutions=(16,),
          ch_mult=(1, 2, 4, 8, 16, 32, 32, 32),
          conditional=True,
          conv_size=3,
          dropout=0.0,
          ema_rate=0.9999,
          fir=True,
          fir_kernel=[1, 3, 3, 1],
          fourier_scale=16,
          init_scale=0.0,
          name='ncsnpp',
          nf=16,
          nonlinearity='swish',
          normalization='GroupNorm',
          num_res_blocks=1,
          num_scales=2000,
          progressive='output_skip',
          progressive_combine='sum',
          progressive_input='input_skip',
          resamp_with_conv=True,
          resblock_type='biggan',
          scale_by_sigma=True,
          sigma_max=1348,
          sigma_min=0.0001,
          skip_rescale=True,
      ),
      'uncsn': dict(
          eta=0.0001,
          threshold='middle',
      ),
  })
