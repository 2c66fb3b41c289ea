"""Model interchange formats: ``mars`` (the `.mars` reader and writer) and
``packing`` (the NNA packed-layout codecs it uses), copied from the JAX
package."""
